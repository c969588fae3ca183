"""Plain float32 references of what the timed paths compute.  They import
``torch`` and ``numpy`` only, nothing of the program, and read the
benchmark's own weights and inputs (``weights.make_tree``'s layout)."""
