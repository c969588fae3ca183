"""Operations and bytes of each hand-written kernel, counted from its
shapes; one file a kernel, frozen copies of the bounds ``chip_smoke.py``
states (``<kernel>.bound_s(...)`` -> (seconds, "bytes" | "operations"))."""
