"""Where the time of one train step goes, on the card.

    python -m espnet_slurp_tpu_torch.bin.profile_train \
        [--model asr|default|transducer] [--fused-conv] [--dropout RATE]
        [--out FILE]

Builds the flagship ASRModel (``asr``, models/asr_model.py:flagship_config,
on the traffic of bench.py:43-58: 64 synthetic 15 s utterances, U = 64), the
default ASRConfig() (``default``: fp32 compute, d_ff 2048, its dropout 0.1,
on the same traffic) or the Conformer-transducer (``transducer``,
models/transducer.py:transducer_flagship_config, conf/train_transducer.yaml:
32 x 15 s, U = 64, vocab 600; bf16 compute like the flagship), fp32
parameters, dropout ``--dropout`` (default 0 for the flagship and the
transducer, 0.1 for ``default``; the recipes train at 0.1), SpecAug on,
random weights from a seeded torch.Generator; ``--fused-conv`` routes the
conv modules through kernel K6. The port's make_train_step runs Adam at
constant lr 1e-3. Runs two warm-up steps, times three more on the host
clock (each ended by a synchronise), then profiles one with
torch.profiler. Prints one JSON line: the unprofiled step seconds and
audio-seconds per second, the peak device memory of those steps; for the
profiled step its wall, device busy time (sum of kernel
times) and idle share, kernel launches, host and device milliseconds of the
train_step.{forward,backward,update} ranges (the backward's kernels run on
the autograd thread, so its device time is the busy time the other two
ranges leave), device time by kind of kernel (the port's own CUDA kernels,
each by name; matrix products; convolutions; elementwise and reductions;
the rest) and the top kernels. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..models.asr_model import ASRConfig, ASRModel, flagship_config
from ..models.transducer import TransducerModel, transducer_flagship_config
from ..train.optim import OptimConfig, build_optimizer
from ..train.state import TrainState, make_train_step
from ..utils.params import init_random_

SECONDS, U, FS = 15, 64, 16000
BATCH = {"asr": 64, "default": 64, "transducer": 32}
RANGES = ("train_step.forward", "train_step.backward", "train_step.update")
KINDS = (("matmul", ("gemm", "sm90_", "cutlass", "xmma", "cublas")),
         ("conv", ("conv", "cudnn", "implicit", "winograd", "fft")),
         ("elementwise", ("elementwise", "reduce", "softmax", "norm",
                          "copy", "fill", "index", "gather", "scatter",
                          "cat", "where")))


def kind_of(name: str) -> str:
    if "espnet" in name:
        return "port_kernels"
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=sorted(BATCH), default="asr")
    ap.add_argument("--fused-conv", action="store_true",
                    help="conv modules through kernel K6")
    ap.add_argument("--dropout", type=float, default=None,
                    help="the encoder's dropout rate (default: 0, or 0.1 "
                         "for --model default)")
    ap.add_argument("--out", help="also write the JSON to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.model in ("asr", "default"):
        base = flagship_config() if args.model == "asr" else ASRConfig()
        rate = args.dropout if args.dropout is not None else (
            base.dropout_rate if args.model == "default" else 0.0)
        cfg = dataclasses.replace(base, fused_conv=args.fused_conv,
                                  dropout_rate=rate)
        model = init_random_(ASRModel(cfg, device="cuda"), seed=0)
    else:
        base = transducer_flagship_config()
        cfg = dataclasses.replace(base, asr=dataclasses.replace(
            base.asr, fused_conv=args.fused_conv,
            dropout_rate=args.dropout or 0.0)).asr
        model = init_random_(TransducerModel(
            dataclasses.replace(base, asr=cfg), device="cuda"), seed=0)
    B = BATCH[args.model]
    tx = build_optimizer(OptimConfig(lr=1e-3, scheduler="constant"))
    state = TrainState.create(model, tx, seed=0)
    step = make_train_step(model, tx)
    rng = np.random.RandomState(0)
    n = FS * SECONDS
    batch = {
        "speech": torch.from_numpy(
            rng.randn(B, n).astype(np.float32) * 0.1).cuda(),
        "speech_lengths": torch.full((B,), n, dtype=torch.int32,
                                     device="cuda"),
        "text": torch.from_numpy(rng.randint(1, cfg.vocab_size - 1,
                                             size=(B, U))).cuda(),
        "text_lengths": torch.full((B,), U, dtype=torch.int32,
                                   device="cuda"),
    }
    for _ in range(2):
        state, st = step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        state, st = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak_mb = torch.cuda.max_memory_allocated() / 1e6

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, st = step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # record_function also leaves a device-side annotation per range; only
    # real kernels count as device work.
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.key not in RANGES]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    by_kind, ours = {}, {}
    for e in kernels:
        k = kind_of(e.key)
        by_kind[k] = by_kind.get(k, 0.0) + e.self_device_time_total / 1e3
        if k == "port_kernels":
            short = e.key.replace("(anonymous namespace)::", "")
            ours[short.split("<")[0].split("(")[0][-40:]] = {
                "count": e.count, "ms": e.self_device_time_total / 1e3}
    ranges = {r: {"host_ms": 0.0, "device_ms": 0.0} for r in RANGES}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name in ranges:
            ranges[e.name]["host_ms"] += e.time_range.elapsed_us() / 1e3
            ranges[e.name]["device_ms"] += e.device_time_total / 1e3
    ranges["train_step.backward"]["device_ms"] = busy_ms - sum(
        ranges[r]["device_ms"] for r in RANGES if r != "train_step.backward")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    step_s = float(np.median(times))
    result = {
        "card": card,
        "model": args.model,
        "fused_conv": args.fused_conv,
        "dtype": cfg.dtype,
        "dropout": cfg.dropout_rate,
        "batch": f"{B} x {SECONDS} s, U {U}, V {cfg.vocab_size}",
        "step_s": step_s,
        "steps_s": times,
        "audio_s_per_s": B * SECONDS / step_s,
        "peak_mb": peak_mb,
        "loss": float(st["loss"]),
        "profiled_wall_s": wall,
        "device_busy_ms": busy_ms,
        "idle_share_profiled": 1.0 - busy_ms / 1e3 / wall,
        "kernel_launches": sum(e.count for e in kernels),
        "ranges": ranges,
        "device_ms_by_kind": by_kind,
        "port_kernels": ours,
        "top_kernels": [{"name": e.key[:70], "count": e.count,
                         "ms": e.self_device_time_total / 1e3} for e in top],
    }
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
