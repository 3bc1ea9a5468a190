"""Times kernel K3's forward (rel-pos flash attention) on the card.

    python -m espnet_slurp_tpu_torch.bin.time_attention [--out FILE]

bf16, H 4, Dh 64 (the flagship's and the transducer's attention), no
chunking, inputs from a seeded torch.Generator: the serving shape (B 8,
T' 471, key lengths 471 - 29 i) and the flagship train shape (B 64, T' 468,
key lengths 468 - 3 i). Each shape, the launch alone (no autograd):
``ms``, the median of four medians of 25 CUDA-event runs of one launch
after 3 warm-ups (chip_smoke.py's way; a launch shorter than the host's
enqueue counts that too), all four kept in ``runs_ms``; ``ms_batched``, the
median of 5 event pairs around 20 back-to-back launches, over 20; and
``device_ms``, torch.profiler's device time per launch over 10 launches.
Prints one JSON line with the card's name and power limit (nvidia-smi) and
the kernel module's path.
To time another checkout's kernel, run this file from that checkout's root
with ``PYTHONPATH=.``. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from espnet_slurp_tpu_torch.ops.kernels import flash_attention as fa

SHAPES = {"serving": (8, 471, 29), "train": (64, 468, 3)}
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


def device_ms(fn, n=10) -> float:
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if "espnet" in e.key]
    return sum(e.self_device_time_total for e in kernels) / 1e3 / n


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
    for name, (b, t, step) in SHAPES.items():
        inputs = case(b, t, step, gen)
        call = lambda: fa._launch_fwd(*inputs, DH ** -0.5, 0, -1)
        times = [median_ms(call) for _ in range(4)]
        result[name] = {"B": b, "T": t, "ms": float(np.median(times)),
                        "runs_ms": times, "ms_batched": batched_ms(call),
                        "device_ms": device_ms(call)}
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
