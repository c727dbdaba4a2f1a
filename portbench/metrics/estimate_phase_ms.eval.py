"""The controller's estimate phase per call (stacking the view pair, the
copy to the card, the estimate): the program's PhaseTimer ``estimate`` total
over its count in the window, in ms a call."""


def read(run):
    totals, counts = run.phases.get("totals", {}), run.phases.get("counts", {})
    if not counts.get("estimate"):
        return None
    return 1e3 * totals["estimate"] / counts["estimate"]
