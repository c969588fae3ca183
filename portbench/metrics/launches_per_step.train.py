"""launches_per_step.train (count): device kernels a training step, in
the profiled stretch (copies and sets left out): the host's dispatch
load."""


def read(rec):
    if rec.get("kind") != "train":
        return None
    return rec["prof"]["launches"] / rec["prof_steps"], "count"
