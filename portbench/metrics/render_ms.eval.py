"""The simulator's rendering per evaluation round: the program's PhaseTimer
``sim/render`` total over the window's rounds, in ms a round."""


def read(run):
    total = run.phases.get("totals", {}).get("sim/render")
    return None if total is None else 1e3 * total / run.counts["rounds"]
