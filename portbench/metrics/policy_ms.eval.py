"""The policy's action per call: the program's PhaseTimer ``policy`` total
over its count in the window, in ms a call."""


def read(run):
    totals, counts = run.phases.get("totals", {}), run.phases.get("counts", {})
    if not counts.get("policy"):
        return None
    return 1e3 * totals["policy"] / counts["policy"]
