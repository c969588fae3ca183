"""Time ``nvcc`` on CUDA sources, one at a time, with the port's flags
(``cuda_build.NVCC_FLAGS``) plus ``-Xptxas -v``, and report each kernel
instance's registers, spills and shared memory as ptxas gives them.

    python src/repro_torch/bench/nvcc_times.py SOURCE.cu [SOURCE.cu ...]

Run by path, so two trees' sources (a parent's and a change's) can be
timed in one process on one machine.  The libraries go to a temporary
directory and are thrown away.  Prints one JSON object: ``{source:
{"seconds": s, "kernels": {mangled name: ptxas info line}}}``.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
from repro_torch.cuda_build import NVCC_FLAGS, nvcc_path  # noqa: E402


def time_source(source: str) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o",
               str(Path(tmp) / "lib.so"), source]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    kernels, name = {}, None
    for line in proc.stderr.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        elif name and ("registers" in line or "spill" in line):
            kernels.setdefault(name, []).append(line.split("info    :")[-1]
                                                .strip())
    return {"seconds": seconds, "kernels": kernels}


def main(argv=None) -> dict:
    sources = sys.argv[1:] if argv is None else argv
    out = {s: time_source(s) for s in sources}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
