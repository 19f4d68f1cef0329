#!/usr/bin/env python3
"""Which CUDA kernels of the port issue tensor-core instructions, from the SASS,
and which compile to the same SASS as another tree's.

Run from the root of a checkout, on a machine with the CUDA toolkit:

    python3 tools/kernel_sass.py [--against OTHER_CSRC_DIR]

It builds ``csrc/din_head.cu``, ``din_attention.cu``, ``afm_attention.cu``,
``serving_topk.cu``, ``mf_epoch.cu``, ``lr_epoch.cu`` and ``din_full_history.cu``
(as the launchers do, into ``build/kernels/``),
disassembles them with ``cuobjdump -sass`` and prints one JSON line per
kernel: its source, its name (demangled) and how many ``HMMA`` (warp-level
tensor-core multiply) instructions its SASS holds. With ``--against`` it also
builds the same sources from another ``csrc`` directory (say, the parent
commit's) with the same flags and says, for each kernel, whether the two SASS
listings are the same instruction for instruction, and whether they are so
but for the numbers of their registers (``same_but_registers``: a kernel
whose source file gained other kernels may be allocated other registers); it
exits 1 if a kernel of ``din_head.cu``, ``serving_topk.cu`` or ``lr_epoch.cu``
(the wide LR trainer's two kernels) that the other tree has differs beyond its
register numbers, but for the
kernels of ``MAY_CHANGE``: ``din_head_bwd_fc_kernel<bf16>`` takes its
operands' bf16 rounding two values at a time (``op4``, the same round to
nearest even); it runs in every bf16 backward, which ``chip_smoke.py`` holds
against its plain version on the card. A kernel the other tree has and this
one does not (``din_head_bwd_kernel<bf16>``: bf16 takes the split at every
width; the two-launch MF and compact LR epoch kernels, which became
``mf_train_kernel`` and ``lr_compact_train_kernel``, one cooperative launch a
run) is not compared, nor a source the other tree lacks (``din_full_history.cu``
before DIN's full-history kernel): its kernels count as new. Branch labels
are renumbered within each kernel, since the disassembler numbers them across
the file. ``din_head_bwd_att_kernel`` became a template on the storage type:
the other tree's float32 kernel is matched to ``din_head_bwd_att_kernel<float>``
(``renamed``); ``din_fwd_kernel`` took the pooled rows' pointer and
``kKOrder``, so its instantiations count as new (its bf16 logits are held
against another tree's by ``tools/din_bwd_digest.py --part fwd``). The DIN
head's forward kernel was ``din_fwd_kernel<true, T>`` before
its pool branch went; its old name is matched to ``din_fwd_kernel<T>``
(``renamed``). ``din_head_bwd_fc_kernel`` takes a staging plan (``FcStage``:
fewer rows, or windows of columns, where a chunk's rows do not fit) that
earlier trees' did not, so it counts as new: ``tools/din_bwd_digest.py`` holds
its results against another tree's bit for bit. Needs ``nvcc``, ``cuobjdump``
and ``cu++filt``, not a card.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from deeplearningrecommendationsystem_tpu_torch.ops.cuda import build  # noqa: E402

SOURCES = ("din_head.cu", "din_attention.cu", "afm_attention.cu", "serving_topk.cu", "mf_epoch.cu",
           "lr_epoch.cu", "din_full_history.cu")
UNCHANGED = ("din_head.cu", "serving_topk.cu", "lr_epoch.cu")
MAY_CHANGE = ("din_head_bwd_fc_kernel<__nv_bfloat16>",)


def renamed(name: str) -> str:
    """An earlier tree's kernel name as this tree calls it: din_fwd_kernel<(bool)1,
    T> became din_fwd_kernel<T>, so its parameters' T2 (the second template
    parameter) became T1; the DIN pool's
    din_pool_kernel<kOnChip> moved to din_pool.cuh's namespace
    and took kB3 (false: the window pool) and a last parameter, b3 (unread
    without kB3)."""
    if name.startswith("<unnamed>::din_head_bwd_att_kernel(const float *"):  # not yet a template
        return "void " + name.replace(
            "din_head_bwd_att_kernel(const float *, const float *, din::AttentionWeights<float>",
            "din_head_bwd_att_kernel<float>(const T1 *, const T1 *, din::AttentionWeights<T1>")
    if "din_fwd_kernel<(bool)1, " in name:
        return name.replace("din_fwd_kernel<(bool)1, ", "din_fwd_kernel<").replace("T2", "T1")
    m = re.fullmatch(r"void <unnamed>::din_pool_kernel<\(bool\)(\d)>\((.*)\)", name)
    if m:
        args = m.group(2).replace("<unnamed>::", "dinpool::")
        return f"void dinpool::din_pool_kernel<(bool){m.group(1)}, (bool)0>({args}, const float *)"
    return name


def registers_renamed(code: list) -> list:
    """The instructions with every register number (R, UR, P, UP) and their
    encodings dropped."""
    return [re.sub(r"\b(U?[RP])\d+\b", r"\1", re.sub(r"/\* 0x[0-9a-f]+ \*/", "", i)).strip()
            for i in code]


def kernels(library: Path, rename=lambda name: name) -> dict:
    """{kernel: [SASS instructions]} of a library, names demangled (then
    ``rename``d), instructions without their addresses."""
    bin_dir = Path(build._nvcc()).parent
    sass = subprocess.run([str(bin_dir / "cuobjdump"), "-sass", str(library)], capture_output=True,
                          text=True, check=True).stdout
    out, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
        elif name and line.strip().startswith("/*") and ";" in line:
            out[name].append(re.sub(r"/\*[0-9a-f]{4,}\*/", "", line).strip())
    for name, code in out.items():  # branch labels are numbered across the file: renumber per kernel
        labels = {}
        out[name] = [re.sub(r"\.L_x_(\d+)", lambda m: f".L_{labels.setdefault(m.group(1), len(labels))}", i)
                     for i in code]
    mangled = list(out)
    names = subprocess.run([str(bin_dir / "cu++filt")], input="\n".join(mangled), capture_output=True,
                           text=True, check=True).stdout.splitlines()
    return {rename(n): out[m] for m, n in zip(mangled, names)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", type=Path, help="another csrc directory to compare with")
    args = ap.parse_args()
    built = build.build_all(SOURCES)
    changed = []
    for source in SOURCES:
        ours = kernels(built[source])
        theirs = None
        if args.against is not None and not (args.against / source).exists():
            theirs = {}
        elif args.against is not None:
            with tempfile.TemporaryDirectory() as tmp:
                lib = Path(tmp) / "lib.so"
                subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                                str(args.against / source)], check=True)
                theirs = kernels(lib, renamed)
        for name, code in sorted(ours.items()):
            row = {"source": source, "kernel": name, "hmma": sum("HMMA" in i for i in code),
                   "instructions": len(code)}
            if theirs is not None:
                other = theirs.get(name, [])
                row["same_sass_as_against"] = other == code
                row["same_but_registers"] = registers_renamed(other) == registers_renamed(code)
                row["hmma_against"] = sum("HMMA" in i for i in other)
                row["new"] = name not in theirs  # no counterpart there (mf_train_kernel, say)
                if (source in UNCHANGED and not row["new"] and not row["same_but_registers"]
                        and not any(m in name for m in MAY_CHANGE)):
                    changed.append(name)
                    diff = [(i, a, b) for i, (a, b) in enumerate(zip(code, other)) if a != b]
                    print(f"kernel_sass: {name}: {len(code)} against {len(other)} instructions, "
                          f"first differences {diff[:5]}", file=sys.stderr)
            print(json.dumps(row), flush=True)
    if changed:
        print(f"kernel_sass: SASS changed in {changed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
