"""Compare the SASS of kernels of the port's ``csrc/swarm_step.cu`` (or,
with ``--source reduce``, ``csrc/swarm_reduce.cu``) as two checkouts
build them.

Builds each checkout's source into a cubin with this checkout's ``nvcc``
flags and macros (``ops/_build.py``, ``swarm_kernels.DEFINES`` for the
step source), once each, disassembles
both with ``cuobjdump -sass``, takes from each the function whose
mangled name matches each pattern, and prints one JSON line a pattern:
each listing's instruction count (``NOP`` padding included), the lines
that differ, the lines that still differ once constant-bank offsets
(where the kernel's arguments live, which move when an argument struct
grows) and branch targets are masked, and how many more of each opcode this
checkout's listing holds.  Both listings and the diffs go under
``--out``, a directory a pattern.

Run on a machine with the CUDA toolkit, from the root of a checkout:
``python3 tools/torch_port_sass.py --other PARENT_CHECKOUT [--kernel
PATTERN ...]`` (default: ``select_admit_kernel<8, false, 1, POL_SPREAD>``;
``--other-kernel`` gives the other checkout's patterns where its
names differ; ``--source reduce --kernel 'timeline_row_kernelILb0EE'
--other-kernel 'timeline_row_kernel12'`` compares TK5 without cohorts
with a build from before its cohort instantiation).
"""

from __future__ import annotations

import argparse
import difflib
import json
import os
import re
import subprocess
import sys
from collections import Counter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
#: the sources by ``--source``: file, and whether it takes the step's macros
SOURCES = {"step": ("swarm_step.cu", True), "reduce": ("swarm_reduce.cu", False)}


def disassemble(checkout: str, out_dir: str, tag: str,
                source: str = "step") -> list:
    """``checkout``'s build of the source as SASS, one entry per
    function."""
    from hlsjs_p2p_wrapper_tpu_torch.ops import _build
    from hlsjs_p2p_wrapper_tpu_torch.ops import swarm_kernels as sk
    name, macros = SOURCES[source]
    flags = [f for f in _build.flags(sk.DEFINES if macros else ())
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    cubin = os.path.join(out_dir, f"{tag}.cubin")
    subprocess.run([_build.nvcc_path(), *flags, "-cubin", "-o", cubin,
                    os.path.join(checkout, "hlsjs_p2p_wrapper_tpu_torch",
                                 "csrc", name)], check=True,
                   capture_output=True, text=True)
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()),
                             "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", cubin], check=True,
                          capture_output=True, text=True).stdout
    return re.split(r"\n\s*Function : ", sass)[1:]


def listing(functions: list, pattern: str, out_dir: str, tag: str):
    """The SASS lines of the function matching ``pattern`` among
    ``functions``, and its mangled name."""
    found = [f for f in functions if re.search(pattern, f.splitlines()[0])]
    if len(found) != 1:
        raise SystemExit(f"{tag}: {len(found)} functions match {pattern!r}")
    lines = found[0].splitlines()
    body = [ln for ln in lines[1:] if re.match(r"\s*/\*[0-9a-f]{4}\*/", ln)]
    with open(os.path.join(out_dir, f"{tag}.sass"), "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return lines[0].strip(), body


def opcodes(body) -> Counter:
    """Each opcode's count in a listing (predicates dropped)."""
    return Counter(m.group(1) for m in (
        re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                 ln) for ln in body) if m)


def instruction(line: str, masked: bool) -> str:
    """One SASS line without its address and encoding; ``masked`` also
    hides constant-bank offsets and branch targets."""
    text = re.sub(r"/\*[0-9a-f]{4}\*/", "", line)
    text = re.sub(r"/\* 0x[0-9a-f]+ \*/", "", text).strip()
    if masked:
        text = re.sub(r"c\[0x[0-9a-f]+\]\[0x[0-9a-f]+\]", "c[*][*]", text)
        text = re.sub(r"(BRA|BSSY|CALL\.REL\.NOINC|BREAK|SYNCS)(.*?)"
                      r"0x[0-9a-f]+", r"\1\2<target>", text)
    return text


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True,
                    help="the checkout to compare with (its root)")
    ap.add_argument("--kernel", nargs="+",
                    default=[r"select_admit_kernelILi8ELb0ELi1ELi0EE"],
                    help="mangled-name patterns of the kernels here")
    ap.add_argument("--other-kernel", nargs="+",
                    help="the patterns there, one per --kernel (default: "
                         "the same)")
    ap.add_argument("--source", choices=sorted(SOURCES), default="step")
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "torch_kernels", "sass"))
    args = ap.parse_args(argv)
    others = args.other_kernel or args.kernel
    if len(others) != len(args.kernel):
        ap.error("--other-kernel needs one pattern per --kernel")
    os.makedirs(args.out, exist_ok=True)
    here_fns = disassemble(ROOT, args.out, "here", args.source)
    there_fns = disassemble(os.path.abspath(args.other), args.out, "other",
                            args.source)
    for n, (pattern, other) in enumerate(zip(args.kernel, others)):
        out = os.path.join(args.out, str(n))
        os.makedirs(out, exist_ok=True)
        print(json.dumps(compare(here_fns, there_fns, pattern, other, out)))
    return 0


def compare(here_fns, there_fns, pattern, other, out):
    """One kernel's report: its listing here against the other
    checkout's, raw and with argument offsets and branch targets
    masked; the listings and diffs go under ``out``."""
    name_a, here = listing(here_fns, pattern, out, "here")
    name_b, there = listing(there_fns, other, out, "other")
    report = {"here": name_a, "other": name_b,
              "instructions": {"here": len(here), "other": len(there)}}
    ops_here, ops_there = opcodes(here), opcodes(there)
    report["opcodes_here_minus_other"] = {
        op: ops_here[op] - ops_there[op]
        for op in sorted(set(ops_here) | set(ops_there))
        if ops_here[op] != ops_there[op]}
    for masked in (False, True):
        a = [instruction(ln, masked) for ln in there]
        b = [instruction(ln, masked) for ln in here]
        diff = list(difflib.unified_diff(a, b, "other", "here", lineterm="",
                                         n=0))
        changed = [ln for ln in diff
                   if ln[:1] in "+-" and ln[:3] not in ("+++", "---")]
        key = "masked" if masked else "raw"
        report[f"{key}_lines_differing"] = len(changed)
        with open(os.path.join(out, f"diff_{key}.txt"), "w") as fh:
            fh.write("\n".join(diff) + "\n")
    return report


if __name__ == "__main__":
    sys.exit(main())
