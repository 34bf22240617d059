"""Device time of the port's replay decode, ``unpack_bits`` (1-bit rows) and
``unpack_crumbs`` (2-bit rows), timed as ``chip_smoke.py`` times its kernels:
20 calls captured in one CUDA graph, CUDA events around a replay, median of 5.

    python scripts/unpack_times.py [--src DIR] [--label NAME] [--variants]

``--src`` is the ``src`` directory of a checkout (default: this checkout's),
so that two versions of the kernels, each in its own checkout, can be timed
in turns on one card: run the script once for each, in one job.  It builds
that checkout's kernels, prints the card's name and power limit, then one
``[unpack-time]`` line per kernel and case:

* ``aligned``: a row of its own at K = 10^6;
* ``row1``: row 1 of a ``(2, B)`` trace at K = 10^6, at byte offset B (8 mod
  16 for the bits, B = 125,000; 0 mod 16 for the crumbs);
* ``offset1``: a row at byte offset 1, where a mesh rank's column slab may
  start;
* ``one_byte``: K = 8 (bits) or K = 4 (crumbs): the kernel's own cost as a
  node of a PyTorch-captured graph, the floor under the K = 10^6 times.

Each line has the bytes the call must move and their time at the card's
memory rate (``bound_ms``), and whether the kernel's output equals its plain
version's.  ``--variants`` also builds ``scripts/unpack_variants.cu`` against
the checkout's kernel source (one with the ``launch_unpack`` template) and
prints an ``[unpack-variant]`` line per kernel, case and variant: 1, 2, 4 or
8 slots a thread, launched as the library launches them (``launch=1``, a
programmatic dependent launch) and as an ordinary launch (``launch=0``), and
2 slots as a programmatic dependent launch that lets the next grid launch at
once (``launch=2``).  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
from block_sums_times import graph_ms  # noqa: E402
from chip_smoke import card_rates  # noqa: E402

K = 1_000_000
KERNELS = (("unpack_bits", 8), ("unpack_crumbs", 4))
# (slots a thread, launch: 1 programmatic dependent, as the library launches;
# 0 ordinary; 2 programmatic dependent that lets the next grid launch at once)
VARIANTS = tuple((vecs, launch) for launch in (1, 0) for vecs in (1, 2, 4, 8)) + ((2, 2),)


def rows(torch, rng, per):
    """The packed rows of each case, ``{case: (row, K)}``."""
    B = -(-K // per)
    trace = torch.from_numpy(rng.integers(0, 256, (2, B), dtype="uint8")).cuda()
    flat = torch.from_numpy(rng.integers(0, 256, B + 1, dtype="uint8")).cuda()
    return {"aligned": (trace[0].clone(), K), "row1": (trace[1], K), "offset1": (flat[1:], K),
            "one_byte": (trace[0, :1].clone(), per)}


def build_variants(src):
    """Compile ``unpack_variants.cu`` against ``src``'s kernel source with the
    library's flags; the loaded library."""
    from repro_torch.kernels import _build

    out = _build.BUILD_DIR / "unpack_variants.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-shared",
           os.path.join(HERE, "unpack_variants.cu"), "-o", str(out)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed on unpack_variants.cu (exit {done.returncode}):\n{done.stdout}{done.stderr}")
    lib = ctypes.CDLL(str(out))
    P = ctypes.c_void_p
    lib.repro_unpack_variant.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, P, P, ctypes.c_int64, P]
    lib.repro_unpack_variant.restype = ctypes.c_int
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(HERE, "..", "src"))
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--variants", action="store_true", help="also time unpack_variants.cu's slot counts")
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("unpack_times: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.kernels import ref, unpack_bits, unpack_crumbs

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    bw, _ = card_rates(torch.cuda.get_device_name(0))
    fns = {"unpack_bits": (unpack_bits, ref.unpack_bits_ref), "unpack_crumbs": (unpack_crumbs, ref.unpack_crumbs_ref)}
    lib = build_variants(args.src) if args.variants else None
    rng = np.random.default_rng(0)
    for kname, per in KERNELS:
        fn, rfn = fns[kname]
        for case, (row, n) in rows(torch, rng, per).items():
            want = rfn(row, n)
            equal = torch.equal(fn(row, n), want)
            ms = graph_ms(torch, lambda: fn(row, n))
            nbytes = -(-n // per) + want.numel() * want.element_size()
            print(f"[unpack-time] src={args.label!r} kernel={kname} case={case} K={n} offset16={row.data_ptr() % 16} "
                  f"ms={ms:.5f} bound_ms={nbytes / bw * 1e3:.5f} equal={equal} card={smi!r}", flush=True)
            if lib is None:
                continue
            out = torch.empty_like(want)
            for vecs, how in VARIANTS:
                def call():
                    err = lib.repro_unpack_variant(int(per == 8), vecs, how, row.data_ptr(), out.data_ptr(), n,
                                                   torch.cuda.current_stream().cuda_stream)
                    if err != 0:
                        raise RuntimeError(f"repro_unpack_variant: CUDA error {err}")
                out.zero_()
                call()
                equal = torch.equal(out, want)
                ms = graph_ms(torch, call)
                print(f"[unpack-variant] kernel={kname} case={case} K={n} vecs={vecs} launch={how} ms={ms:.5f} "
                      f"equal={equal} card={smi!r}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
