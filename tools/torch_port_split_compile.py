"""Time the step source's build with and without ``nvcc
--split-compile`` and compare the SASS of every kernel the two builds
hold.

``ops/_build.py`` builds ``csrc/swarm_step.cu`` with ``--split-compile
0`` (``SPLIT_SOURCES``): ``nvcc`` splits the device code into parallel
jobs, one a core.  This tool builds the step source twice with the
port's flags and macros (``_build.flags``, ``swarm_kernels.DEFINES``),
without the split and with it, one build after the other (each alone on
the machine's cores), and prints one JSON line a build (its seconds and
``ptxas``'s line count) and a last line comparing the two: how many
functions each holds and how many are identical instruction for
instruction (``cuobjdump -sass``, addresses dropped, encodings kept).

Run on a machine with the CUDA toolkit, from the root of a checkout:
``python3 tools/torch_port_split_compile.py`` (~75 s on an H100 host's 8
cores).
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def build(out_dir: str, tag: str, split: bool) -> dict:
    """Build the step source into ``<out_dir>/<tag>.so``: its seconds,
    ``ptxas``'s line count and its SASS by function."""
    from hlsjs_p2p_wrapper_tpu_torch.ops import _build
    from hlsjs_p2p_wrapper_tpu_torch.ops import swarm_kernels as sk
    flags = _build.flags(sk.DEFINES, sk.SOURCE if split else "")
    lib = os.path.join(out_dir, f"{tag}.so")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_build.nvcc_path(), *flags, "-o", lib,
         os.path.join(_build.CSRC_DIR, sk.SOURCE)],
        capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise SystemExit(f"{tag}: nvcc failed\n{proc.stdout}{proc.stderr}")
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()),
                             "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib], check=True,
                          capture_output=True, text=True).stdout
    functions = {}
    for chunk in re.split(r"\n\s*Function : ", sass)[1:]:
        lines = chunk.splitlines()
        functions[lines[0].strip()] = [
            re.sub(r"/\*[0-9a-f]{4}\*/", "", ln).strip()
            for ln in lines[1:] if re.match(r"\s*/\*[0-9a-f]{4}\*/", ln)]
    log = proc.stdout + proc.stderr
    return {"seconds": seconds, "split": split,
            "ptxas_lines": sum("ptxas" in ln for ln in log.splitlines()),
            "functions": functions}


def main() -> int:
    with tempfile.TemporaryDirectory() as out_dir:
        builds = {}
        for tag, split in (("whole", False), ("split", True)):
            builds[tag] = build(out_dir, tag, split)
            print(json.dumps({"build": tag, "split": split,
                              "seconds": builds[tag]["seconds"],
                              "ptxas_lines": builds[tag]["ptxas_lines"],
                              "functions": len(builds[tag]["functions"])}),
                  flush=True)
    a, b = builds["whole"]["functions"], builds["split"]["functions"]
    same = sorted(name for name in a if a[name] == b.get(name))
    print(json.dumps({"functions": [len(a), len(b)],
                      "identical": len(same),
                      "only_in_one": sorted(set(a) ^ set(b)),
                      "differ": sorted(set(a) & set(b) - set(same))}))
    return 0 if len(same) == len(a) == len(b) else 1


if __name__ == "__main__":
    sys.exit(main())
