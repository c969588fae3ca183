"""launches_per_step.serve (count): device kernels an engine step in the
profiled stretch (copies and sets left out): what the engine and the
model step dispatch."""


def read(rec):
    if rec.get("kind") != "serve":
        return None
    return rec["prof"]["launches"] / rec["prof_steps"], "count"
