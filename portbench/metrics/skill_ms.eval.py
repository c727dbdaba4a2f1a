"""The scripted skill per evaluation round: the program's PhaseTimer
``skill`` total over the window's rounds, in ms a round."""


def read(run):
    total = run.phases.get("totals", {}).get("skill")
    return None if total is None else 1e3 * total / run.counts["rounds"]
