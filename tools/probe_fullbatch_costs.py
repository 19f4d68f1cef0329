#!/usr/bin/env python3
"""What the fused full-batch trainers pay for, piece by piece, on one card.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 tools/probe_fullbatch_costs.py

It builds ``tools/probe_fullbatch_costs.cu`` with the port's nvcc flags and,
on ``chip_smoke.py``'s synthetic MF train batch (229,350 rows, 943 users,
1,682 items, D 64, float32), prints one JSON line of device times (CUDA
events over back-to-back runs, inputs warm):

* the two-launch MF epoch (``mf_epoch_kernel`` before it became one
  persistent launch, float32) whole, without its item gradient, without its
  user gradient, and as the forward alone; its Adam launch alone;
* 20 such epochs launched from a Python loop through ctypes (as that
  launcher did) and from one C loop;
* an empty kernel launched back to back from C and from Python;
* one grid barrier (``cooperative_groups::this_grid().sync()``) at 1, 2, 4 and
  8 blocks of 256 threads an SM;
* the L2 gather rate: the batch's item rows (user order) gathered by warps
  with 1, 4 or 8 rows in flight, float32 and bf16 tables.

Then the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from deeplearningrecommendationsystem_tpu_torch.ops.cuda import build  # noqa: E402

P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def load() -> ctypes.CDLL:
    out = build.BUILD_DIR / "probe_fullbatch_costs.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                    str(ROOT / "tools" / "probe_fullbatch_costs.cu")], check=True)
    lib = ctypes.CDLL(str(out))
    lib.probe_parent_epoch.argtypes = [I, P, P, P, P, P, P, P, P, LL, I, I, I, P]
    lib.probe_parent_adam.argtypes = [P, P, P, P, LL, I, P]
    lib.probe_parent_run_c.argtypes = [I, P, P, P, P, P, P, P, P, LL, I, I, I, P]
    lib.probe_empty.argtypes = [I, P]
    lib.probe_max_coop_blocks.argtypes = [I]
    lib.probe_grid_sync.argtypes = [I, I, I, P, P]
    lib.probe_gather.argtypes = [I, I, P, P, LL, I, P, I, P]
    return lib


def ok(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")


def device_ms(fn, reps: int) -> float:
    """Device ms of one call of ``fn``: events around ``reps`` calls, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_fullbatch_costs: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from deeplearningrecommendationsystem_tpu_torch.configs import PRESETS
    from deeplearningrecommendationsystem_tpu_torch.experiments import split_batches

    lib = load()
    s = torch.cuda.current_stream().cuda_stream
    with tempfile.TemporaryDirectory() as tmp:
        ds = cs.make_dataset(tmp)
        (uid, iid), y = split_batches(PRESETS["mf"], ds, "cuda")["train"]
    uid, iid, y = uid.int().contiguous(), iid.int().contiguous(), y.float().contiguous()
    B, U, I_, D, E = uid.shape[0], ds.num_users, ds.num_items, 64, 20
    gen = torch.Generator(device="cuda").manual_seed(0)
    p = 0.1 * torch.randn((U + I_) * D, generator=gen, device="cuda")
    m, v, d = (torch.zeros_like(p) for _ in range(3))
    loss = torch.zeros(E, device="cuda")
    pu, pi = p[:U * D], p[U * D:]
    du, di = d[:U * D], d[U * D:]
    out = {"rows": B, "users": U, "items": I_, "dim": D}

    def epoch(mode):
        return lambda: ok(lib.probe_parent_epoch(mode, uid.data_ptr(), iid.data_ptr(), y.data_ptr(),
                                                 pu.data_ptr(), pi.data_ptr(), du.data_ptr(),
                                                 di.data_ptr(), loss.data_ptr(), B, U, I_, D, s),
                          "epoch")

    for mode, label in ((0, "epoch_kernel_ms"), (2, "epoch_no_item_grad_ms"),
                        (1, "epoch_no_user_grad_ms"), (3, "forward_only_ms")):
        out[label] = device_ms(epoch(mode), 200)
    n = p.numel()
    out["adam_ms"] = device_ms(lambda: ok(lib.probe_parent_adam(
        p.data_ptr(), m.data_ptr(), v.data_ptr(), d.data_ptr(), n, 1, s), "adam"), 200)

    def run_py():
        for e in range(E):
            epoch(0)()
            ok(lib.probe_parent_adam(p.data_ptr(), m.data_ptr(), v.data_ptr(), d.data_ptr(), n,
                                     e + 1, s), "adam")

    def run_c():
        ok(lib.probe_parent_run_c(E, uid.data_ptr(), iid.data_ptr(), y.data_ptr(), p.data_ptr(),
                                  m.data_ptr(), v.data_ptr(), d.data_ptr(), loss.data_ptr(), B, U,
                                  I_, D, s), "run_c")

    out["two_launch_epoch_from_python_ms"] = device_ms(run_py, 20) / E
    out["two_launch_epoch_from_c_ms"] = device_ms(run_c, 20) / E
    out["empty_launch_from_c_us"] = device_ms(lambda: ok(lib.probe_empty(1000, s), "empty"), 5)
    out["empty_launch_from_python_us"] = device_ms(
        lambda: [ok(lib.probe_empty(1, s), "empty") for _ in range(1000)], 5)

    flag = torch.zeros(1, dtype=torch.int32, device="cuda")
    most = lib.probe_max_coop_blocks(256)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out["grid_sync_us"] = {}
    for per_sm in (1, 2, 4, 8):
        blocks = sms * per_sm
        if blocks > most:
            continue
        syncs = 2000
        t = device_ms(lambda: ok(lib.probe_grid_sync(blocks, 256, syncs, flag.data_ptr(), s),
                                 "grid sync"), 5)
        t0 = device_ms(lambda: ok(lib.probe_grid_sync(blocks, 256, 0, flag.data_ptr(), s),
                                  "grid sync"), 20)
        out["grid_sync_us"][f"{blocks} blocks"] = (t - t0) * 1e3 / syncs
    out["grid_sync_max_blocks_256_threads"] = most

    order = torch.argsort(uid, stable=True)
    ids = iid[order].contiguous()
    tables = {"float32": pi.reshape(I_, D).contiguous(),
              "bfloat16": pi.reshape(I_, D).to(torch.bfloat16).contiguous()}
    sink = torch.empty(sms * 8 * 8, device="cuda")
    out["gather"] = {}
    for name, table in tables.items():
        for R in (1, 4, 8):
            t = device_ms(lambda: ok(lib.probe_gather(int(name == "bfloat16"), R, ids.data_ptr(),
                                                      table.data_ptr(), B, D, sink.data_ptr(),
                                                      sms * 8, s), "gather"), 200)
            out["gather"][f"{name} R{R}"] = {"ms": t, "GB_s": B * D * table.element_size() / t / 1e6}
    print(json.dumps(out), flush=True)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
