"""Times kernel K3 (rel-pos flash attention) on the card, both directions.

    python -m espnet_slurp_tpu_torch.bin.time_attention [--out FILE]

bf16, H 4, Dh 64 (the flagship's and the transducer's attention), no
chunking, inputs from a seeded torch.Generator. The forward (``_launch_fwd``)
at the serving shape (B 8, T' 471, key lengths 471 - 29 i) and the flagship
train shape (B 64, T' 468, key lengths 468 - 3 i). The backward
(``_launch_bwd``: delta, the dkv and dq launches, dp's cast), fed the
forward kernel's out and lse, at the flagship train shape and the
transducer's (B 32) with full key lengths, as both train steps give it, and
at the flagship train shape with key lengths 468 - 3 i. Each case, the
wrapper's launch alone (no autograd): ``ms``, the median of four medians of
25 CUDA-event runs of one call after 3 warm-ups (chip_smoke.py's way; a
launch shorter than the host's enqueue counts that too), all four kept in
``runs_ms``; ``ms_batched``, the median of 5 event pairs around 20
back-to-back calls, over 20; and ``device_ms``, torch.profiler's device
time of the port's kernels per call over 10 calls (backward: also ``dq_ms``
and ``dkv_ms``, each launch's own). Prints one JSON line with the card's
name and power limit (nvidia-smi) and the kernel module's path.
To time another checkout's kernels, run this file with that checkout's
root as the working directory and ``PYTHONPATH=.``. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from espnet_slurp_tpu_torch.ops.kernels import flash_attention as fa

# name: (backward?, B, T', key lengths T' - step i)
CASES = {"serving": (False, 8, 471, 29), "train": (False, 64, 468, 3),
         "train_bwd": (True, 64, 468, 0), "transducer_bwd": (True, 32, 468, 0),
         "train_bwd_ragged": (True, 64, 468, 3)}
H, DH = 4, 64


def median_ms(fn, warmup=3, reps=25) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def batched_ms(fn, n=20, reps=5) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return float(np.median(times))


def device_ms(fn, parts, n=10) -> dict:
    """torch.profiler's device time per call of fn, over n calls, of the
    port's kernels whose name holds each part (by label)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if "espnet" in e.key]
    return {label: sum(e.self_device_time_total for e in kernels
                       if part in e.key) / 1e3 / n
            for label, part in parts.items()}


def case(b, t, step, gen):
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda") * 0.5
    p = r(H, 2 * t, DH)
    p[:, -1] = 0.0
    lengths = torch.tensor([t - step * i for i in range(b)],
                           dtype=torch.int32, device="cuda")
    bf = torch.bfloat16
    return [r(b, H, t, DH).to(bf) for _ in range(4)] + [p.to(bf), lengths]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_attention: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {"card": card, "module": fa.__file__}
    scale = DH ** -0.5
    for name, (backward, b, t, step) in CASES.items():
        inputs = case(b, t, step, gen)
        parts = {"device_ms": "espnet"}
        if backward:
            out, lse = fa._launch_fwd(*inputs, scale, 0, -1)
            g = torch.randn(out.shape, generator=gen,
                            device="cuda").to(out.dtype)
            call = lambda: fa._launch_bwd(*inputs, out, lse, g, scale, 0, -1)
            parts.update(dq_ms="dq_kernel", dkv_ms="dkv_kernel")
        else:
            call = lambda: fa._launch_fwd(*inputs, scale, 0, -1)
        times = [median_ms(call) for _ in range(4)]
        result[name] = {"B": b, "T": t, "step": step,
                        "ms": float(np.median(times)), "runs_ms": times,
                        "ms_batched": batched_ms(call),
                        **device_ms(call, parts)}
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
