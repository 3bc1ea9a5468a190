"""Times kernel K2's forward (fused FFN) and K4's backward (fused CTC head).

    python -m espnet_slurp_tpu_torch.bin.time_kernels [--out FILE]

bf16, inputs from a seeded torch.Generator. K2's forward (``_launch_fwd``,
D 256, F 1024) at N = 8 x 471 (serving), 64 x 468 (flagship train step)
and 32 x 468 (transducer train step); K4's backward (``_launch_bwd``, fed
the forward kernel's z) at the flagship train step's shape (B 64, T' 468,
D 256, V 5000, S 129, blanks between labels and repeated labels). Each
case, the wrapper's launch alone (no autograd): ``ms``, the median of four
medians of 25 CUDA-event runs of one call after 3 warm-ups (chip_smoke.py's
way), all four kept in ``runs_ms``; ``ms_batched``, the median of 5 event
pairs around 20 back-to-back calls, over 20 (both timers are
bin/time_attention.py's); ``kernels_ms``, torch.profiler's device time per
launch of each of the port's kernels over 10 calls, and ``device_ms``,
their sum (each kernel launches once a call); ``peak_mb``, what one call
adds to peak memory; ``plain_ms``, the plain composition's time (K2:
fused_ffn_plain; K4: autograd's backward of fused_ctc_head_emit_plain) by
the same events. Prints one JSON line with the card's name and power limit
(nvidia-smi) and the kernel modules' paths. To time another checkout's
kernels, run this file with that checkout's root as the working directory
and ``PYTHONPATH=.``. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from espnet_slurp_tpu_torch.bin.time_attention import batched_ms, median_ms
from espnet_slurp_tpu_torch.ops.kernels import ctc_head as kh
from espnet_slurp_tpu_torch.ops.kernels import ffn

D, F_FF, V, U = 256, 1024, 5000, 64
# name: rows of K2's forward
FFN_CASES = {"ffn_fwd_serving": 8 * 471, "ffn_fwd_train": 64 * 468,
             "ffn_fwd_transducer": 32 * 468}
HEAD_B, HEAD_T = 64, 468


def kernels_ms(fn, n=10) -> dict:
    """torch.profiler's device time per launch of each of the port's
    kernels that fn launches (once a call each), by name, over n calls,
    averaged over the launches the profiler recorded."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / e.count
            for e in prof.key_averages() if "espnet" in e.key and e.count}


def peak_mb(fn) -> float:
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 1e6


def timed(call, plain) -> dict:
    times = [median_ms(call) for _ in range(4)]
    per_kernel = kernels_ms(call)
    return {"ms": float(np.median(times)), "runs_ms": times,
            "ms_batched": batched_ms(call),
            "device_ms": sum(per_kernel.values()), "kernels_ms": per_kernel,
            "peak_mb": peak_mb(call), "plain_ms": median_ms(plain)}


def head_case(gen):
    """K4's backward inputs at the flagship train shape, and the autograd
    backward of its plain version on them."""
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    b, t, s = HEAD_B, HEAD_T, 2 * U + 1
    ext = torch.zeros(b, s, dtype=torch.int32, device="cuda")
    labels = torch.randint(1, V - 1, (b, U), generator=gen, device="cuda",
                           dtype=torch.int32)
    labels[:, 1::7] = labels[:, ::7][:, :labels[:, 1::7].shape[1]]
    ext[:, 1::2] = labels
    bf = torch.bfloat16
    hs, w, bias = (r(b, t, D) * 0.5).to(bf), (r(V, D) * D ** -0.5).to(bf), \
        r(V) * 0.1
    g = r(b, t, s)
    _, z = kh._launch_fwd(hs, w, bias, ext)
    leaves = [x.detach().requires_grad_(True) for x in (hs, w, bias)]
    emit = kh.fused_ctc_head_emit_plain(*leaves, ext)
    plain = lambda: torch.autograd.grad(emit, leaves, g, retain_graph=True)
    return (lambda: kh._launch_bwd(hs, w, bias, ext, z, g)), plain


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_kernels: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {"card": card, "modules": [ffn.__file__, kh.__file__]}
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    bf = torch.bfloat16
    w1, b1 = (r(D, F_FF) * D ** -0.5).to(bf), r(F_FF) * 0.1
    w2, b2 = (r(F_FF, D) * F_FF ** -0.5).to(bf), r(D) * 0.1
    for name, n in FFN_CASES.items():
        x = r(n, D).to(bf)
        result[name] = {"N": n, **timed(
            lambda: ffn._launch_fwd(x, w1, b1, w2, b2),
            lambda: ffn.fused_ffn_plain(x, w1, b1, w2, b2))}
    call, plain = head_case(gen)
    result["ctc_head_bwd_train"] = {"B": HEAD_B, "T": HEAD_T, "V": V,
                                    **timed(call, plain)}
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
