"""Times kernel K2's forward (fused FFN) and K4's backward (fused CTC head),
or with ``--wmma`` the launches of the default ASRConfig's fp32 path (K2's
register-tiled GEMM ones, ffn_f32::hidden_kernel and out_kernel forward,
rows_kernel, dx_kernel and dw_kernel backward; K3's register micro-tile
ones) and K3's bf16 WMMA launches, or with ``--head-fp32`` K4's fp32 route
(the default ASRConfig's CTC head) both ways, or with ``--head-lattice``
K4's bf16 forward (the flagship's CTC head) and K1 (the CTC lattice) both
ways, or with ``--conv`` K6 (the fused conv module) in bf16 both ways, or
with ``--conv-fp32`` K6 in fp32 both ways, or with ``--rnnt`` K5 (the RNN-T
lattice) both ways.

    python -m espnet_slurp_tpu_torch.bin.time_kernels [--out FILE]
    python -m espnet_slurp_tpu_torch.bin.time_kernels --wmma [--rate R]
    python -m espnet_slurp_tpu_torch.bin.time_kernels --head-fp32
    python -m espnet_slurp_tpu_torch.bin.time_kernels --head-lattice
    python -m espnet_slurp_tpu_torch.bin.time_kernels --conv
    python -m espnet_slurp_tpu_torch.bin.time_kernels --conv-fp32
    python -m espnet_slurp_tpu_torch.bin.time_kernels --rnnt

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
their sum; ``peak_mb``, what one call adds to peak memory; ``plain_ms``,
the plain composition's time (K2: fused_ffn_plain; K4: autograd's backward
of fused_ctc_head_emit_plain) by the same events; K4's ``eager_ms``,
the eager composition of its function (F.linear -> log_softmax -> gather;
autograd's backward of it). ``--head-fp32`` times K4 the same way in fp32
at that shape, forward (``_launch_fwd``) and backward, each beside its
plain version and the eager composition. ``--head-lattice`` times K4's bf16
forward (``_launch_fwd``) the same way beside its plain version and the
eager composition, and K1's forward and backward (``_launch_fwd``,
``_launch_bwd``: B 64, T' 468, key lengths T' - 3 b, S 129 from U 64
labels over V 5000 log-probs) beside their plain versions (5 runs) and
F.ctc_loss both ways (``library_ms``), with ``us_per_frame`` over T'.
``--conv`` times K6's bf16 forward (``_launch_fwd``) and backward
(``_launch_bwd``; D 256, k 31, SAME, key lengths T' - 7 b) the same way
at the transducer train step's shape (B 32, T' 468) and the flagship's
(B 64, T' 468; the flagship trains with ``fused_conv`` off), the forward
also at the greedy decode's (B 8, T' 471, 468 valid frames), each beside
its plain version (the forward; autograd's backward of it) and, at the
transducer shape, beside the eager ``ConvModule`` with the same weights
(``eager_ms`` by events, ``eager_device_ms`` by torch.profiler: the sum of
its kernels' times a call, from a window whose launches match an earlier
window's, ``eager_launches`` a call). ``--conv-fp32`` times K6's fp32 route
(``conv_f32``: the default ASRConfig's with ``fused_conv``) the same way at
the transducer and flagship shapes, each beside the eager fp32
``ConvModule``, with TF32 off for products and convolutions (the eager
module's depthwise conv is cuDNN's).
``--rnnt`` times K5's forward (``_launch_fwd``) and backward
(``_launch_bwd``, fed the forward's alpha residual) at the transducer train
step's lattice (B 32, T' 468, U1 65, fp32 tables of log-softmaxed logits,
T'_b = 468 - 3 b, U_b = 64 - b % 5) the same way (``ms``, ``runs_ms``,
``kernels_ms``, ``device_ms``, ``peak_mb``), with ``us_per_step`` over the
T' + U1 - 1 anti-diagonals, beside the plain version (5 runs; autograd's
backward of it).
``--wmma`` instead times, at rate
0 and (``--rate`` above 0) at that dropout rate, each direction's launches
of K2's fp32 route (N 64 x 468, D 256, d_ff 2048: the default ASRConfig's
train step) and of K3 (B 64, T' 468, key lengths T' - 3 b: fp32 at H 4,
Dh 64, the default ASRConfig's, through the rel_f32 kernels; bf16 at H 2,
Dh 128, through the WMMA ones): ``ms`` (the median of two event medians of 3 runs after
one warm-up) and ``kernels_ms`` / ``device_ms`` (torch.profiler over 5
calls, by kernel name). Prints one JSON line with the card's name
and power limit (nvidia-smi) and the kernel modules' paths. To time
another checkout's kernels, run this file with that checkout's root as
the working directory and ``PYTHONPATH=.``. Needs a CUDA device.
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
from espnet_slurp_tpu_torch.ops.kernels import flash_attention as fa

D, F_FF, V, U = 256, 1024, 5000, 64
# name: rows of K2's forward
FFN_CASES = {"ffn_fwd_serving": 8 * 471, "ffn_fwd_train": 64 * 468,
             "ffn_fwd_transducer": 32 * 468}
HEAD_B, HEAD_T = 64, 468
# --wmma: rows and width of K2's fp32 launches; (dtype, H, Dh) of K3's
# fp32 and bf16 Dh-128 launches at B 64, T' 468.
WMMA_N, WMMA_F, WMMA_B, WMMA_T = 64 * 468, 2048, 64, 468
WMMA_ATT = {"fp32_dh64": (torch.float32, 4, 64),
            "bf16_dh128": (torch.bfloat16, 2, 128)}
WMMA_SEED = 20241017


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


def ffn_wmma_inputs(r, n=WMMA_N, d=D, f=WMMA_F):
    """K2's fp32 case from the draw ``r``: (x [N, D], W1 [D, F], b1,
    W2 [F, D], b2) and a cotangent [N, D], fp32."""
    x, g = r(n, d), r(n, d)
    return (x, r(d, f) * d ** -0.5, r(f) * 0.1, r(f, d) * f ** -0.5,
            r(d) * 0.1), g


def attention_wmma_inputs(r, dtype, h, dh, b=WMMA_B, t=WMMA_T):
    """K3's WMMA case from the draw ``r``: (q_u, q_v, k, v [B, H, T, Dh], p
    [H, 2T, Dh] with its unused last row 0, in ``dtype``; key lengths
    T - 3 b) and a cotangent [B, H, T, Dh] in ``dtype``."""
    lengths = torch.tensor([t - 3 * i for i in range(b)], dtype=torch.int32,
                           device="cuda")
    p = r(h, 2 * t, dh) * 0.5
    p[:, -1] = 0.0
    args = [(r(b, h, t, dh) * 0.5).to(dtype) for _ in range(4)] + [
        p.to(dtype), lengths]
    return args, r(b, h, t, dh).to(dtype)


def wmma_cases(gen, rate):
    """(name, call) of each WMMA launch at ``rate``: K2 fp32 forward and
    backward, then K3's forward and backward per WMMA_ATT entry."""
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    seed = torch.tensor([WMMA_SEED], dtype=torch.int32, device="cuda") \
        if rate > 0 else None
    (x, w1, b1, w2, b2), g = ffn_wmma_inputs(r)
    cases = [("k2_fp32_fwd", lambda: ffn._launch_fwd(x, w1, b1, w2, b2, seed,
                                                     rate)),
             ("k2_fp32_bwd", lambda: ffn._launch_bwd(x, w1, b1, w2, g, seed,
                                                     rate))]
    for name, (dt, h, dh) in WMMA_ATT.items():
        args, go = attention_wmma_inputs(r, dt, h, dh)
        scale = dh ** -0.5
        out, lse = fa._launch_fwd(*args, scale, 0, -1, seed, rate)
        cases += [
            (f"k3_{name}_fwd", lambda a=args, s=scale: fa._launch_fwd(
                *a, s, 0, -1, seed, rate)),
            (f"k3_{name}_bwd", lambda a=args, s=scale, o=out, l=lse, c=go:
             fa._launch_bwd(*a, o, l, c, s, 0, -1, seed, rate))]
    return cases


def wmma_timings(gen, rate) -> dict:
    out = {}
    for name, call in wmma_cases(gen, rate):
        times = [median_ms(call, warmup=1, reps=3) for _ in range(2)]
        per_kernel = kernels_ms(call, n=5)
        out[name] = {"rate": rate, "ms": float(np.median(times)),
                     "runs_ms": times, "device_ms": sum(per_kernel.values()),
                     "kernels_ms": per_kernel}
    return out


def head_case(gen, dtype=torch.bfloat16):
    """K4's inputs at the flagship train shape in ``dtype``: {name: call}
    of its forward and backward launches (the backward fed the forward's
    z), the plain version (its forward; autograd's backward of it) and the
    eager composition F.linear -> log_softmax -> gather (its forward, with
    autograd's graph as in training; autograd's backward of it)."""
    import torch.nn.functional as F
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    b, t, s = HEAD_B, HEAD_T, 2 * U + 1
    ext = torch.zeros(b, s, dtype=torch.int32, device="cuda")
    labels = torch.randint(1, V - 1, (b, U), generator=gen, device="cuda",
                           dtype=torch.int32)
    labels[:, 1::7] = labels[:, ::7][:, :labels[:, 1::7].shape[1]]
    ext[:, 1::2] = labels
    hs, w, bias = (r(b, t, D) * 0.5).to(dtype), \
        (r(V, D) * D ** -0.5).to(dtype), r(V) * 0.1
    g = r(b, t, s)
    _, z = kh._launch_fwd(hs, w, bias, ext)
    leaves = [x.detach().requires_grad_(True) for x in (hs, w, bias)]
    emit = kh.fused_ctc_head_emit_plain(*leaves, ext)
    idx = ext.long()[:, None, :].expand(b, t, s)
    lin = [x.detach().clone().requires_grad_(True)
           for x in (hs, w, bias.to(dtype))]
    eager = lambda: F.log_softmax(F.linear(*lin).float(), -1).gather(2, idx)
    y = eager()
    return {
        "fwd": lambda: kh._launch_fwd(hs, w, bias, ext),
        "bwd": lambda: kh._launch_bwd(hs, w, bias, ext, z, g),
        "plain_fwd": lambda: kh.fused_ctc_head_emit_plain(hs, w, bias, ext),
        "plain_bwd": lambda: torch.autograd.grad(emit, leaves, g,
                                                 retain_graph=True),
        "eager_fwd": eager,
        "eager_bwd": lambda: torch.autograd.grad(y, lin, g,
                                                 retain_graph=True)}


def lattice_case(gen):
    """K1's inputs at the flagship train shape: {name: call} of its forward
    and backward launches (the backward fed the forward's alpha), the plain
    version (its forward; autograd's backward of it) and F.ctc_loss on the
    log-probs the emissions were gathered from (its forward; autograd's
    backward of it)."""
    import torch.nn.functional as F
    from espnet_slurp_tpu_torch.ops.kernels import ctc as kctc
    b, t = HEAD_B, HEAD_T
    labels = torch.randint(1, V - 1, (b, U), generator=gen, device="cuda")
    ulen = torch.tensor([U - (i % 5) for i in range(b)], device="cuda")
    ext, skip, smax, last = kctc.extend_labels(labels, ulen)
    tlen = torch.tensor([t - 3 * i for i in range(b)], dtype=torch.int32,
                        device="cuda")
    lp = torch.log_softmax(torch.randn(b, t, V, generator=gen,
                                       device="cuda") * 2.0, -1)
    emit = kctc.mask_emit(lp.gather(2, ext[:, None, :].expand(b, t, -1)),
                          smax).contiguous()
    g = torch.rand(b, generator=gen, device="cuda")
    args = (emit, skip, tlen, last)
    _, alpha = kctc._launch_fwd(*args)
    leaf = emit.detach().requires_grad_(True)
    plain = kctc.ctc_lattice_plain(leaf, skip, tlen, last)
    lpt = lp.transpose(0, 1).detach().requires_grad_(True)
    ctc = lambda: F.ctc_loss(lpt, labels, tlen.long(), ulen, blank=0,
                             reduction="none", zero_infinity=True)
    lib = ctc()
    return {
        "fwd": lambda: kctc._launch_fwd(*args),
        "bwd": lambda: kctc._launch_bwd(*args, alpha, g),
        "plain_fwd": lambda: kctc.ctc_lattice_plain(*args),
        "plain_bwd": lambda: torch.autograd.grad(plain, leaf, g,
                                                 retain_graph=True),
        "library_fwd": ctc,
        "library_bwd": lambda: torch.autograd.grad(lib, lpt, g,
                                                   retain_graph=True)}


def device_ms(fn, n=10, windows=5) -> tuple:
    """torch.profiler's device time of everything fn launches, a call, over
    n calls: (ms, {kernel name: launches a call}, windows profiled). On the
    card the profiler has been seen to lose all of a window's kernel
    records, or all of one kernel's, while it kept the window's runtime
    calls, and to lose the first few records of a window that tracing
    starts with. So each window traces one call (the schedule's warm-up)
    before the n it keeps, each call synchronised so that none runs into
    the next step, and a window is taken only when its launches by kernel
    name equal those of an earlier window; after ``windows`` windows with
    no two alike this raises."""
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    seen = []
    for w in range(windows):
        got = []
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=n),
                     on_trace_ready=lambda p: got.extend(p.key_averages())
                     ) as prof:
            for _ in range(n + 1):
                fn()
                torch.cuda.synchronize()
                prof.step()
        kernels = [e for e in got if e.self_device_time_total > 0]
        counts = {e.key: e.count for e in kernels}
        if counts and counts in seen:
            return (sum(e.self_device_time_total for e in kernels) / 1e3 / n,
                    {k: c / n for k, c in counts.items()}, w + 1)
        seen.append(counts)
    raise RuntimeError(f"no two of {windows} profiler windows recorded the "
                       "same launches")


CONV_K = 31
# name: (B, T', valid frames of utterance b, directions timed)
CONV_CASES = {"transducer": (32, 468, lambda b: 468 - 7 * b, ("fwd", "bwd")),
              "flagship": (64, 468, lambda b: 468 - 7 * (b % 32),
                           ("fwd", "bwd")),
              "decode": (8, 471, lambda b: 468, ("fwd",))}


def conv_timings(gen, dt=torch.bfloat16) -> dict:
    """--conv: K6 in bf16 at CONV_CASES' shapes, the eager ConvModule at
    the transducer's; --conv-fp32: in fp32 at its train shapes, the eager
    fp32 ConvModule at both."""
    from espnet_slurp_tpu_torch.models.conformer import ConvModule
    from espnet_slurp_tpu_torch.ops.kernels import conv_module as kc
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    k = CONV_K
    params = (r(2 * D, D) * D ** -0.5, r(2 * D) * 0.1, r(D, k) * k ** -0.5,
              r(D) * 0.1, 1.0 + 0.1 * r(D), r(D) * 0.1, r(D, D) * D ** -0.5,
              r(D) * 0.1)
    w1, b1, wdw, bdw, gamma, beta, w2, b2 = params
    fp32 = dt == torch.float32
    cases = {n: c for n, c in CONV_CASES.items()
             if not fp32 or n != "decode"}
    out = {}
    for name, (b, t, valid, ways) in cases.items():
        lengths = torch.tensor([valid(i) for i in range(b)],
                               dtype=torch.int32, device="cuda")
        args = (r(b, t, D).to(dt), lengths, w1.to(dt), b1, wdw, bdw, gamma,
                beta, w2.to(dt), b2)
        g = r(b, t, D).to(dt)
        leaves = [a.detach().clone().requires_grad_(a.is_floating_point())
                  for a in args]
        y = kc.fused_conv_module_plain(*leaves, kernel_size=k)
        diff = [a for a in leaves if a.requires_grad]
        calls = {"fwd": (lambda: kc._launch_fwd(*args, k, k // 2, 1e-6),
                         lambda: kc.fused_conv_module_plain(*args,
                                                            kernel_size=k)),
                 "bwd": (lambda: kc._launch_bwd(*args[:-1], g, k, k // 2,
                                                1e-6),
                         lambda: torch.autograd.grad(y, diff, g,
                                                     retain_graph=True))}
        key = "conv_fp32" if fp32 else "conv"
        for way in ways:
            out[f"{key}_{way}_{name}"] = {"B": b, "T": t, "D": D, "k": k,
                                          **timed(*calls[way])}
        del y, leaves, diff
        if name != "transducer" and not fp32:
            continue
        mod = ConvModule(D, k).cuda()
        with torch.no_grad():
            for p, v in zip((mod.pointwise1.weight, mod.pointwise1.bias,
                             mod.depthwise.weight, mod.depthwise.bias,
                             mod.norm.weight, mod.norm.bias,
                             mod.pointwise2.weight, mod.pointwise2.bias),
                            params):
                p.copy_(v.view_as(p))
        mask = torch.arange(t, device="cuda")[None, :] < lengths[:, None]
        xe = args[0].detach().requires_grad_(True)
        fwd = lambda: mod(xe, mask)
        ye = fwd()
        grads = [xe] + list(mod.parameters())
        bwd = lambda: torch.autograd.grad(ye, grads, g, retain_graph=True)
        for way, fn in (("fwd", fwd), ("bwd", bwd)):
            dev, launches, _ = device_ms(fn)
            out[f"{key}_{way}_{name}"].update(eager_ms=median_ms(fn),
                                              eager_device_ms=dev,
                                              eager_launches=sum(
                                                  launches.values()))
        del ye, grads, mod
    return out


RNNT_B, RNNT_T, RNNT_U = 32, 468, 64


def rnnt_timings(gen) -> dict:
    """--rnnt: K5 both ways at the transducer train step's lattice."""
    from espnet_slurp_tpu_torch.ops.kernels import transducer as kt
    b, t, u1 = RNNT_B, RNNT_T, RNNT_U + 1
    lp = torch.log_softmax(torch.randn(b, t, u1, 8, generator=gen,
                                       device="cuda") * 2.0, -1)
    blank = lp[..., 0].contiguous()
    emit = lp[..., 1].clone()
    emit[..., -1] = kt.NEG
    del lp
    tlen = torch.tensor([t - 3 * i for i in range(b)], dtype=torch.int32,
                        device="cuda")
    ulen = torch.tensor([RNNT_U - (i % 5) for i in range(b)],
                        dtype=torch.int32, device="cuda")
    g = torch.rand(b, generator=gen, device="cuda")
    args = (blank, emit, tlen, ulen)
    _, alpha = kt._launch_fwd(*args)
    leaves = [x.detach().clone().requires_grad_(True) for x in (blank, emit)]
    plain = kt.rnnt_lattice_plain(*leaves, tlen, ulen)
    calls = {"fwd": (lambda: kt._launch_fwd(*args),
                     lambda: kt.rnnt_lattice_plain(*args)),
             "bwd": (lambda: kt._launch_bwd(*args, alpha, g),
                     lambda: torch.autograd.grad(plain, leaves, g,
                                                 retain_graph=True))}
    out = {}
    for way, (call, plain_call) in calls.items():
        times = [median_ms(call) for _ in range(4)]
        per_kernel = kernels_ms(call)
        ms = float(np.median(times))
        out[f"rnnt_{way}"] = {
            "B": b, "T": t, "U1": u1, "ms": ms, "runs_ms": times,
            "us_per_step": 1e3 * ms / (t + u1 - 1),
            "device_ms": sum(per_kernel.values()), "kernels_ms": per_kernel,
            "peak_mb": peak_mb(call),
            "plain_ms": median_ms(plain_call, warmup=1, reps=5)}
    return out


def head_lattice_timings(gen) -> dict:
    """--head-lattice: K4's bf16 forward and K1 both ways."""
    out = {}
    case = head_case(gen)
    out["ctc_head_bf16_fwd"] = {"B": HEAD_B, "T": HEAD_T, "V": V,
                                **timed(case["fwd"], case["plain_fwd"]),
                                "eager_ms": median_ms(case["eager_fwd"])}
    del case
    case = lattice_case(gen)
    for way in ("fwd", "bwd"):
        times = [median_ms(case[way]) for _ in range(4)]
        per_kernel = kernels_ms(case[way])
        ms = float(np.median(times))
        out[f"ctc_lattice_{way}"] = {
            "B": HEAD_B, "T": HEAD_T, "S": 2 * U + 1, "ms": ms,
            "runs_ms": times, "us_per_frame": 1e3 * ms / HEAD_T,
            "device_ms": sum(per_kernel.values()), "kernels_ms": per_kernel,
            "plain_ms": median_ms(case[f"plain_{way}"], warmup=1, reps=5),
            "library_ms": median_ms(case[f"library_{way}"])}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--wmma", action="store_true",
                    help="time K2's and K3's fp32 launches and K3's bf16 "
                    "Dh-128 ones instead")
    ap.add_argument("--rate", type=float, default=0.0,
                    help="with --wmma, also time them at this dropout rate")
    ap.add_argument("--head-fp32", action="store_true",
                    help="time K4's fp32 route both ways instead")
    ap.add_argument("--head-lattice", action="store_true",
                    help="time K4's bf16 forward and K1 both ways instead")
    ap.add_argument("--conv", action="store_true",
                    help="time K6's bf16 forward and backward instead")
    ap.add_argument("--conv-fp32", action="store_true",
                    help="time K6's fp32 forward and backward instead")
    ap.add_argument("--rnnt", action="store_true",
                    help="time K5's forward and backward instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_kernels: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {"card": card, "modules": [ffn.__file__, kh.__file__]}
    if args.wmma:
        torch.backends.cuda.matmul.allow_tf32 = False
        result["rate_0"] = wmma_timings(gen, 0.0)
        if args.rate > 0:
            result[f"rate_{args.rate}"] = wmma_timings(gen, args.rate)
        return emit(result, args.out)
    if args.head_lattice:
        result.update(head_lattice_timings(gen))
        return emit(result, args.out)
    if args.conv:
        result.update(conv_timings(gen))
        return emit(result, args.out)
    if args.conv_fp32:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        result.update(conv_timings(gen, torch.float32))
        return emit(result, args.out)
    if args.rnnt:
        result.update(rnnt_timings(gen))
        return emit(result, args.out)
    if args.head_fp32:
        torch.backends.cuda.matmul.allow_tf32 = False
        case = head_case(gen, torch.float32)
        for way in ("fwd", "bwd"):
            result[f"ctc_head_fp32_{way}"] = {
                "B": HEAD_B, "T": HEAD_T, "V": V,
                **timed(case[way], case[f"plain_{way}"]),
                "eager_ms": median_ms(case[f"eager_{way}"])}
        return emit(result, args.out)
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    bf = torch.bfloat16
    w1, b1 = (r(D, F_FF) * D ** -0.5).to(bf), r(F_FF) * 0.1
    w2, b2 = (r(F_FF, D) * F_FF ** -0.5).to(bf), r(D) * 0.1
    for name, n in FFN_CASES.items():
        x = r(n, D).to(bf)
        result[name] = {"N": n, **timed(
            lambda: ffn._launch_fwd(x, w1, b1, w2, b2),
            lambda: ffn.fused_ffn_plain(x, w1, b1, w2, b2))}
    case = head_case(gen)
    result["ctc_head_bwd_train"] = {"B": HEAD_B, "T": HEAD_T, "V": V,
                                    **timed(case["bwd"], case["plain_bwd"]),
                                    "eager_ms": median_ms(case["eager_bwd"])}
    return emit(result, args.out)


def emit(result, out) -> int:
    line = json.dumps(result)
    print(line)
    if out:
        with open(out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
