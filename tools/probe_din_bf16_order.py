#!/usr/bin/env python3
"""Why the bf16 DIN head's backward recomputes its attention unit on CUDA cores.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 tools/probe_din_bf16_order.py [--seeds 1 2 3] [--rows 87900]

The bf16 head multiplies on the tensor cores (``csrc/din_common.cuh``,
``block_mm_mma``), but its backward recomputes the attention unit's forward,
whose relu masks decide every gradient, on CUDA cores: at the train batch the
backward is the split (``din_head_bwd_fc_stream_kernel``, whose fc head sums on
the tensor cores and sums again in k order the relu inputs near 0, then
``din_head_bwd_att_kernel<bf16>``, whose ``attention_forward<T, false>``
recomputes z1 and z2). This probe builds the library as shipped and a variant
whose recompute of the attention unit runs on the tensor cores too (a copy of
``din_head.cu`` with ``attention_forward<T, false>`` made ``true``, built
beside the shipped library), and holds each, on
``chip_smoke.py``'s DIN inputs at the train batch (rows at a float32 relu kink
set aside, as its bf16 check does), against two references:

* ``plain``: the plain bf16 head on the card, float32 sums (cuBLAS), the
  reference of ``chip_smoke.py``'s bf16 checks;
* ``exact``: the same with every product summed in float64 from the same bf16
  operands, then rounded to float32.

For each pair it prints the rows of d hist or d target off by more than
``DIN_BF16_BWD_RTOL`` of the tensor's largest |value| (the check's criterion;
such rows have a relu mask flipped) and the bf16 logits that differ. The
forward kernel is the same in both builds. Then the card's name and power
limit. It needs a card: without one it exits non-zero.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from deeplearningrecommendationsystem_tpu_torch.ops import din_head as dh  # noqa: E402
from deeplearningrecommendationsystem_tpu_torch.ops.cuda import build  # noqa: E402
from deeplearningrecommendationsystem_tpu_torch.ops.cuda import din_head as cuda_dh  # noqa: E402

RECOMPUTE = ("din::attention_forward<T, false>(a, s, sm);",)


def tensor_core_recompute() -> Path:
    """Build din_head.cu with the backward's recompute on the tensor cores."""
    src = (build.CSRC_DIR / "din_head.cu").read_text()
    for call in RECOMPUTE:
        if call not in src:
            raise RuntimeError(f"din_head.cu no longer has {call!r}")
        src = src.replace(call, call.replace("<T, false>", "<T, true>"))
    out_dir = build.BUILD_DIR / "probe_din_bf16_order"
    out_dir.mkdir(parents=True, exist_ok=True)
    for header in build.CSRC_DIR.glob("*.cuh"):
        (out_dir / header.name).write_text(header.read_text())
    (out_dir / "din_head.cu").write_text(src)
    lib = out_dir / "din_head_tensor_recompute.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(out_dir / "din_head.cu")],
                   check=True)
    return lib


def float64_products(on: bool, saved=(dh._mdot, dh._cdot)) -> None:
    """Swap the plain head's products for float64 sums of the same operands."""
    if on:
        dh._mdot = lambda a, b: (a.to(b.dtype).double() @ b.double()).float()
        dh._cdot = lambda a, b, dt: (a.to(dt).double().T @ b.to(dt).double()).float()
    else:
        dh._mdot, dh._cdot = saved


def rows_off(x, y) -> int:
    def beyond(got, want):
        return ((got - want).abs().reshape(got.shape[0], -1).amax(dim=1)
                > cs.DIN_BF16_BWD_RTOL * float(want.abs().max()))
    return int((beyond(x[0], y[0]) | beyond(x[1], y[1])).sum())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])
    ap.add_argument("--rows", type=int, default=87_900)  # the DIN train batch of chip_smoke.py
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_din_bf16_order: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain head in full float32
    shipped = cuda_dh._lib
    variant = cuda_dh.bind(ctypes.CDLL(str(tensor_core_recompute())))
    D, A, F = 64, cs.DIN_ATTENTION, cs.DIN_FC
    for seed in args.seeds:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        hist, tgt, att, fc, g = cs.din_inputs(args.rows, 10, D, A, F, gen)
        hist, tgt, g = hist.bfloat16(), tgt.bfloat16(), g.bfloat16()
        att, fc = ([{k: v.bfloat16() for k, v in layer.items()} for layer in net] for net in (att, fc))
        weights = dh.din_head_weights(att, fc, D)
        dist, near = cs.kink_distance(hist, tgt, weights, cs.DIN_BF16_KINK)
        smooth = dist > cs.DIN_KINK
        sub = (hist[smooth].contiguous(), tgt[smooth].contiguous(), weights, g[smooth].contiguous())
        grads = {"plain": dh.din_head_bwd_plain(*sub)}
        logits = {"plain": dh.din_head_fwd_plain(*sub[:3])}
        float64_products(True)
        try:
            grads["exact"], logits["exact"] = dh.din_head_bwd_plain(*sub), dh.din_head_fwd_plain(*sub[:3])
        finally:
            float64_products(False)
        logits["kernel"] = dh.din_head_fwd(*sub[:3])
        pooled = cuda_dh.din_head_fused_pooled(*sub[:3])[1]  # the same forward in both builds
        grads["cuda-core recompute"] = dh.din_head_bwd(*sub, pooled=pooled)
        cuda_dh._lib = lambda: variant
        try:
            grads["tensor-core recompute"] = dh.din_head_bwd(*sub, pooled=pooled)
        finally:
            cuda_dh._lib = shipped
        torch.cuda.synchronize()
        print(json.dumps({
            "seed": seed, "rows": int(smooth.sum()),
            "rows_off": {f"{a} vs {b}": rows_off(grads[a], grads[b])
                         for a in ("cuda-core recompute", "tensor-core recompute", "plain")
                         for b in ("plain", "exact") if a != b},
            "logits_off": {f"{a} vs {b}": int((logits[a] != logits[b]).sum())
                           for a, b in (("kernel", "plain"), ("kernel", "exact"), ("plain", "exact"))},
            "limit_rows_off": int(-(-cs.DIN_BF16_OFF_SHARE * int(near[smooth].sum()) // 1)),
            "limit_logits_off": cs.DIN_BF16_LOGITS_OFF,
        }), flush=True)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
