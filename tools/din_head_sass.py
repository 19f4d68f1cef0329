#!/usr/bin/env python3
"""Which of the DIN kernels issue tensor-core instructions, from the SASS.

Run from the root of a checkout, on a machine with the CUDA toolkit:

    python3 tools/din_head_sass.py [--against OTHER_CSRC_DIR]

It builds ``csrc/din_head.cu`` and ``csrc/din_attention.cu`` (as the
launchers do, into ``build/kernels/``), disassembles them with ``cuobjdump
-sass`` and prints one JSON line per kernel: its source, its name and how many
``HMMA`` (warp-level tensor-core multiply) instructions its SASS holds. With
``--against`` it also builds both from another ``csrc`` directory (say, an
earlier commit's) with the same flags and says, for each kernel, whether the
two SASS listings are the same instruction for instruction. Needs ``nvcc`` and
``cuobjdump``, not a card.
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

SOURCES = ("din_head.cu", "din_attention.cu")


def kernels(library: Path) -> dict:
    """{kernel: [SASS instructions]} of a library, names without the anonymous
    namespace's per-file hash, instructions without their addresses."""
    cuobjdump = Path(build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(library)], capture_output=True, text=True,
                          check=True).stdout
    out, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = re.sub(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}", "(anonymous)", m.group(1))
            out[name] = []
        elif name and line.strip().startswith("/*") and ";" in line:
            out[name].append(re.sub(r"/\*[0-9a-f]{4,}\*/", "", line).strip())
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", type=Path, help="another csrc directory to compare with")
    args = ap.parse_args()
    built = build.build_all(SOURCES)
    for source in SOURCES:
        ours = kernels(built[source])
        theirs = None
        if args.against is not None:
            with tempfile.TemporaryDirectory() as tmp:
                lib = Path(tmp) / "lib.so"
                subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                                str(args.against / source)], check=True)
                theirs = kernels(lib)
        for name, code in sorted(ours.items()):
            row = {"source": source, "kernel": name, "hmma": sum("HMMA" in i for i in code),
                   "instructions": len(code)}
            if theirs is not None:
                row["same_sass_as_against"] = theirs.get(name) == code
                row["hmma_against"] = sum("HMMA" in i for i in theirs.get(name, []))
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
