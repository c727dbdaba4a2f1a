"""Multi-device training: the (dp, tp) mesh and its shardings (``mesh``),
and one process per rank (``launch``)."""
