"""decode_share.serve (%): the share of the slot-steps the engine
advanced that produced a token (the rest fed a prompt token, one a step):
the program's counters ``serve.tokens`` over ``serve.slot_steps`` in the
profiled stretch (``portbench/spans.py``)."""
from portbench import spans


def read(rec):
    if rec.get("kind") != "serve":
        return None
    got = spans.tallies(rec)
    if got is None or not got[1].get("serve.slot_steps"):
        return None
    c = got[1]
    return 100.0 * c.get("serve.tokens", 0) / c["serve.slot_steps"], "%"
