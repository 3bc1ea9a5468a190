#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port's serving path on one NVIDIA card.

Run from the repository root: ``python3 chip_smoke.py`` (no arguments, one
card). It exits non-zero, printing no result, when there is no CUDA device
or the port's package is not beside it. Phases, each of which fails the run:

1. The card's name and power limit; the hand-written kernels are built from
   espnet_slurp_tpu_torch/csrc (nvcc, sm_90a) and the build time printed.
2. Kernels at the flagship shapes the serving path gives them: K2 fused FFN
   (N = 8 utterances x T' rows, D 256, F 1024) and K3 rel-pos flash
   attention (B 8, H 4, T', Dh 64, ragged lengths, unchunked and chunk 16 /
   left 4), each against its plain PyTorch version on the same inputs in
   bf16 (error <= 2e-2 of max |ref|) and fp32 (<= 1e-4 of max |ref|), then
   timed with CUDA events (median of 25 after 3 warm-up runs) beside its
   plain version, a PyTorch yardstick where one call computes the same
   function, and its bound on an H100 SXM.
3. The slice: a flagship-width Speech2Text (random weights from a seeded
   torch.Generator) decodes 8 synthetic 15 s utterances with beam 10,
   pre-beam 30, ctc_weight 0.3, max_len 96 (the traffic of bench.py). The
   kernels' launch counts are zeroed just before that decode and must read
   24 (K2) and 12 (K3) just after it. Then two short utterances are encoded
   in fp32 with the same weights on the CPU (plain versions) and on the card
   (kernels), and the valid frames compared (<= 1e-3 of max |ref|: twelve
   stacked blocks, fp32 sums in another order).

The line before the last is the ``{"kernels": [...]}`` JSON; the last line
is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import time

import numpy as np

# Traffic of bench.py:128-133.
N_UTT, UTT_SECONDS, FS = 8, 15, 16000
BEAM, CTC_WEIGHT, MAX_LEN = 10, 0.3, 96  # pre-beam: Speech2Text's 30
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
TOL = {"bfloat16": 2e-2, "float32": 1e-4}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def median_ms(torch, fn, warmup=3, reps=25) -> float:
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


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def rel_err(out, ref):
    diff = (out.float() - ref.float()).abs().max().item()
    return diff, diff / max(ref.float().abs().max().item(), 1e-30)


def check_ffn(torch, ffn, rows, d, f, gen):
    """K2 against its plain version in bf16 and fp32; returns bf16 inputs
    and the bf16 max abs error."""
    dev = "cuda"
    base = dict(x=torch.randn(rows, d, generator=gen, device=dev),
                w1=torch.randn(d, f, generator=gen, device=dev) * d ** -0.5,
                b1=torch.randn(f, generator=gen, device=dev) * 0.1,
                w2=torch.randn(f, d, generator=gen, device=dev) * f ** -0.5,
                b2=torch.randn(d, generator=gen, device=dev) * 0.1)
    err_bf16, args_bf16 = None, None
    for dt in (torch.bfloat16, torch.float32):
        args = (base["x"].to(dt), base["w1"].to(dt), base["b1"],
                base["w2"].to(dt), base["b2"])
        out = ffn.fused_ffn(*args)
        torch.cuda.synchronize()
        ref = ffn.fused_ffn_plain(*args)
        err, rel = rel_err(out, ref)
        name = str(dt).split(".")[-1]
        print(f"K2 fused_ffn {name} N={rows} D={d} F={f}: max abs err "
              f"{err:.3e}, {rel:.3e} of max|ref| (tolerance {TOL[name]})")
        if not rel <= TOL[name]:
            raise AssertionError(f"K2 {name} disagrees with its plain version")
        if dt == torch.bfloat16:
            err_bf16, args_bf16 = err, args
    return args_bf16, err_bf16


def check_attention(torch, fa, b, h, t, dh, gen):
    """K3 against its plain version (valid query rows, out and lse) in bf16
    and fp32, unchunked and chunked; returns the unchunked bf16 inputs and
    the bf16 max abs error."""
    dev = "cuda"
    lengths = torch.tensor([t - 29 * i for i in range(b)], dtype=torch.int32,
                           device=dev)
    base = [torch.randn(b, h, t, dh, generator=gen, device=dev) * 0.5
            for _ in range(4)]
    p = torch.randn(h, 2 * t, dh, generator=gen, device=dev) * 0.5
    p[:, -1] = 0.0
    valid = (torch.arange(t, device=dev)[None, :]
             < lengths[:, None].long())[:, None, :]  # [B, 1, T]
    scale = dh ** -0.5
    err_bf16, args_bf16 = 0.0, None
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).split(".")[-1]
        args = [x.to(dt) for x in base] + [p.to(dt), lengths]
        for cs, lc in ((0, -1), (16, 4)):
            out, lse = fa.rel_flash_attention_fwd(
                *args, scale=scale, chunk_size=cs, left_chunks=lc)
            torch.cuda.synchronize()
            ref, ref_lse = fa.rel_flash_attention_plain(
                *args, scale=scale, chunk_size=cs, left_chunks=lc)
            m = valid[..., None]
            err, rel = rel_err(torch.where(m, out, 0), torch.where(m, ref, 0))
            _, rel_lse = rel_err(torch.where(valid, lse, 0),
                                 torch.where(valid, ref_lse, 0))
            print(f"K3 rel_flash_attention {name} B={b} H={h} T={t} Dh={dh} "
                  f"chunk=({cs},{lc}): out max abs err {err:.3e}, "
                  f"{rel:.3e} of max|ref|; lse {rel_lse:.3e} (tolerance "
                  f"{TOL[name]})")
            if not (rel <= TOL[name] and rel_lse <= TOL[name]):
                raise AssertionError(
                    f"K3 {name} chunk=({cs},{lc}) disagrees with its plain "
                    f"version")
            if dt == torch.bfloat16 and cs == 0:
                err_bf16, args_bf16 = err, args
    return args_bf16, err_bf16, scale


def kernel_phase(torch, t_prime):
    from espnet_slurp_tpu_torch.models.asr_model import flagship_config
    from espnet_slurp_tpu_torch.ops.kernels import ffn
    from espnet_slurp_tpu_torch.ops.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(0)
    cfg = flagship_config()
    d, f, h = cfg.d_model, cfg.d_ff, cfg.n_head
    dh = d // h
    rows = N_UTT * t_prime
    ffn_args, ffn_err = check_ffn(torch, ffn, rows, d, f, gen)
    att_args, att_err, scale = check_attention(torch, fa, N_UTT, h, t_prime,
                                               dh, gen)

    # K2 timings: no single PyTorch call computes swish(x W1 + b1) W2 + b2.
    ffn_ms = median_ms(torch, lambda: ffn.fused_ffn(*ffn_args))
    ffn_plain_ms = median_ms(torch, lambda: ffn.fused_ffn_plain(*ffn_args))
    ffn_bound = bound(4.0 * rows * d * f,
                      2 * (2 * rows * d + 2 * d * f) + 4 * (f + d))

    # K3 timings; the yardstick is SDPA over a precomputed additive bias
    # (rel-shifted position scores + mask), the bias build not timed.
    q_u, q_v, k, v, p, lengths = att_args
    b, _, t, _ = q_u.shape
    att_ms = median_ms(torch, lambda: fa.rel_flash_attention_fwd(
        *att_args, scale=scale))
    att_plain_ms = median_ms(torch, lambda: fa.rel_flash_attention_plain(
        *att_args, scale=scale))
    raw = q_v.float() @ p[:, :2 * t - 1].float().transpose(-1, -2)
    bd = raw.gather(-1, fa.rel_shift_index(t, raw.device).expand(b, h, t, t))
    allowed = fa.allowed_mask(t, lengths)
    bias = torch.where(allowed, bd * scale, fa.NEG).to(q_u.dtype)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = median_ms(torch, lambda: sdpa(q_u, k, v, attn_mask=bias,
                                           scale=scale))
    pairs = float(allowed.sum().item()) * h  # (query, visible key) pairs
    att_bytes = 2 * (5 * b * h * t * dh + h * 2 * t * dh) + 4 * b * h * t \
        + 4 * b
    att_bound = bound(3 * 2.0 * pairs * dh, att_bytes)
    del raw, bd, bias
    return [
        dict(name="fused_ffn", route="cuda",
             source="espnet_slurp_tpu_torch/csrc/ffn.cu",
             replaces="espnet_slurp_tpu/ops/pallas/ffn.py:128",
             launches=None, max_abs_err=ffn_err, ms=ffn_ms,
             plain_ms=ffn_plain_ms, bound_ms=ffn_bound[0],
             bound_by=ffn_bound[1], library_ms=None),
        dict(name="rel_flash_attention", route="cuda",
             source="espnet_slurp_tpu_torch/csrc/flash_attention.cu",
             replaces="espnet_slurp_tpu/ops/pallas/flash_attention.py:280",
             launches=None, max_abs_err=att_err, ms=att_ms,
             plain_ms=att_plain_ms, bound_ms=att_bound[0],
             bound_by=att_bound[1], library_ms=lib_ms),
    ]


def token_list(vocab: int):
    return ["<blank>", "<unk>"] + [f"w{i}" for i in range(vocab - 3)] \
        + ["<sos/eos>"]


def slice_phase(torch, card):
    from espnet_slurp_tpu_torch.decode.beam import BeamSearchConfig
    from espnet_slurp_tpu_torch.models.asr_model import (ASRModel,
                                                          flagship_config)
    from espnet_slurp_tpu_torch.ops.kernels.ffn import fused_ffn
    from espnet_slurp_tpu_torch.ops.kernels.flash_attention import (
        rel_flash_attention_fwd)
    from espnet_slurp_tpu_torch.tasks.asr import Speech2Text
    from espnet_slurp_tpu_torch.utils.params import init_random_

    cfg = flagship_config()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    state = init_random_(ASRModel(cfg32, device="cpu"), seed=0).state_dict()
    tokens = token_list(cfg.vocab_size)
    s2t = Speech2Text(cfg, state, tokens, token_type="word",
                      max_len=MAX_LEN, beam_size=BEAM, ctc_weight=CTC_WEIGHT,
                      device="cuda")
    rng = np.random.RandomState(0)
    speeches = [rng.randn(FS * UTT_SECONDS).astype(np.float32) * 0.1
                for _ in range(N_UTT)]
    t0 = time.perf_counter()
    s2t.decode_batch(speeches)  # warm-up: cuBLAS/cuDNN handles, allocator
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    fused_ffn.launches = 0
    rel_flash_attention_fwd.launches = 0
    t0 = time.perf_counter()
    texts = s2t.decode_batch(speeches)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fused_ffn": fused_ffn.launches,
                "rel_flash_attention": rel_flash_attention_fwd.launches}
    print(f"slice: {N_UTT} x {UTT_SECONDS} s, beam {BEAM}, pre-beam "
          f"{BeamSearchConfig().pre_beam_size}, ctc {CTC_WEIGHT}, max_len {MAX_LEN}: wall {wall:.3f} s"
          f" (first call {warm_s:.3f} s), RTF {wall / (N_UTT * UTT_SECONDS):.5f}"
          f" on {card}; launches {launches}")
    n_blocks = cfg.num_encoder_blocks
    if launches != {"fused_ffn": 2 * n_blocks,
                    "rel_flash_attention": n_blocks}:
        raise AssertionError(f"main path launches {launches}, expected "
                             f"{2 * n_blocks} and {n_blocks} per encode")
    vocab = set(tokens) - {"<blank>", "<sos/eos>"}
    if len(texts) != N_UTT or not all(
            isinstance(x, str) and len(x.split()) <= MAX_LEN
            and set(x.split()) <= vocab for x in texts):
        raise AssertionError(f"malformed decode output: {texts!r:.500}")
    print(f"slice: hypothesis lengths {[len(x.split()) for x in texts]}")

    # fp32: the same weights on the CPU (plain versions) and on the card.
    short = [rng.randn(n).astype(np.float32) * 0.1 for n in (48000, 33600)]
    enc = {}
    for dev in ("cpu", "cuda"):
        model = ASRModel(cfg32, device=dev)
        model.load_state_dict(state)
        buf, lens = s2t.pad_batch(short)
        with torch.inference_mode():
            hs, hl = model.encode(torch.from_numpy(buf).to(dev),
                                  torch.from_numpy(lens).to(dev))
            lp = model.ctc_logprobs(hs)
        enc[dev] = (hs.cpu(), hl.cpu(), lp.cpu())
    (hs_c, hl_c, lp_c), (hs_g, hl_g, lp_g) = enc["cpu"], enc["cuda"]
    if not torch.equal(hl_c, hl_g):
        raise AssertionError("fp32 encode: lengths differ")
    for i in range(len(short)):
        n = int(hl_c[i])
        for name, a, b in (("hs", hs_g, hs_c), ("ctc_logprobs", lp_g, lp_c)):
            err, rel = rel_err(a[i, :n], b[i, :n])
            print(f"fp32 encode utt {i} ({n} frames) {name}: max abs err "
                  f"{err:.3e}, {rel:.3e} of max|ref| (tolerance 1e-3)")
            if not (torch.isfinite(a[i, :n]).all() and rel <= 1e-3):
                raise AssertionError(f"fp32 encode {name} card vs CPU")
    return launches, wall


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from espnet_slurp_tpu_torch.data.sampler import bucket_length
    from espnet_slurp_tpu_torch.models.embedding import Conv2dSubsampling
    from espnet_slurp_tpu_torch.ops.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card)  # exactly as nvidia-smi gives it
    t0 = time.perf_counter()
    build.library()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s")
    for line in build.build_log().splitlines():
        if re.search(r"Compiling entry|registers|spill", line):
            print("  " + line.strip())

    # T' of a 15 s utterance as Speech2Text pads it (bucket of 4096 samples,
    # hop 128, x4 subsampling).
    n = bucket_length(FS * UTT_SECONDS, 4096)
    t_prime = Conv2dSubsampling.out_length_static(1 + n // 128)
    kernels = kernel_phase(torch, t_prime)
    launches, _ = slice_phase(torch, card)
    for kern in kernels:
        kern["launches"] = launches[kern["name"]]
        print(f"{kern['name']}: {kern['ms']:.4f} ms (plain {kern['plain_ms']:.4f}"
              f" ms, library {kern['library_ms']}, bound {kern['bound_ms']:.4f}"
              f" ms by {kern['bound_by']}) on {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
