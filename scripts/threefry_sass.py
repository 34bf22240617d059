"""The instruction mix of the threefry kernel as nvcc compiles it for sm_90a:
which pipe the adds, rotates and xors of a hash issue on.

    python scripts/threefry_sass.py [--src DIR] [--out FILE]

Builds the kernels (``repro_torch.kernels._build.build``; needs ``nvcc``),
disassembles the library with ``cuobjdump -sass`` and prints, for
each draw kernel (both layouts; ``.vec``: the 16-byte stores' instance), and
the rows and categorical kernels (``rows<...>``, ``categorical<...>``: their
template's values), the
count of each opcode (its modifiers kept: ``IMAD.IADD`` is an add issued on
the FMA pipe, ``IADD3`` one on the ALU pipe) in two parts: before the
block's ``BAR.SYNC`` (the key's folds) and after it (the grid-stride loop:
a group of counters, their hashes and epilogues).  Uniform-datapath opcodes (``U*``) run once a warp on a
pipe of their own.  One JSON object a kernel; with ``--out`` also written to
``FILE``.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import re
import subprocess
import sys


MODES = ("keys", "bits", "sortkey", "uniform", "gumbel", "normal")  # the kernel's Mode enum, in order
_FUNCTION = re.compile(r"Function : (\S+)")
_OPCODE = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)")
_MODE = re.compile(r"threefry_(orig_)?kernelILi(\d)E(?:Lb(\d)E)?")
_OTHER = re.compile(r"(threefry_rows|categorical)_kernel(I(?:L[bi]\d+E)+E)?")  # the rows and categorical kernels


def sass_counts(text: str) -> dict:
    """``{mode: {"fold": Counter, "loop": Counter}}`` of the threefry
    kernels in a ``cuobjdump -sass`` listing."""
    out, part = {}, None
    for line in text.splitlines():
        m = _FUNCTION.search(line)
        if m:
            mode = _MODE.search(m.group(1))
            part = None
            if mode:
                name = ("original." if mode.group(1) else "") + MODES[int(mode.group(2))]
                name += {"1": ".vec", "0": ".scalar"}.get(mode.group(3), "")  # 16-byte stores or not
                counts = out.setdefault(name, {"fold": collections.Counter(), "loop": collections.Counter()})
                part = "fold"
            other = _OTHER.search(m.group(1))
            if other and not mode:  # rows<orig...>, categorical<bf16, orig...>: the template's values
                name = f"{other.group(1).replace('threefry_', '')}<{','.join(re.findall(r'L[bi](\d+)E', other.group(2) or ''))}>"
                counts = out.setdefault(name, {"fold": collections.Counter(), "loop": collections.Counter()})
                part = "fold"
            continue
        m = _OPCODE.search(line)
        if part is None or not m:
            continue
        op = m.group(1)
        counts[part][op] += 1
        if op.startswith("BAR.SYNC") or op == "BAR":
            part = "loop"
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--src", default=os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"),
                    help="the src directory of the checkout whose kernels to read (default: this one's)")
    ap.add_argument("--out", default=None, help="also write the JSON lines here")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.kernels._build import _nvcc, build

    lib, _ = build()
    cuobjdump = os.path.join(os.path.dirname(os.path.realpath(_nvcc())), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True, check=True).stdout
    lines = []
    for mode, parts in sass_counts(text).items():
        lines.append(json.dumps({"kernel": f"threefry.{mode}", "arch": "sm_90a",
                                 **{p: dict(sorted(c.items())) for p, c in parts.items()}}))
    if not lines:
        raise SystemExit(f"no threefry kernel in the SASS of {lib}")
    print("\n".join(lines))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
