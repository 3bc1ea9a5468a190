"""Where the time of one flagship serving decode goes, on the card.

    python -m espnet_slurp_tpu_torch.bin.profile_decode [--out FILE]

Builds the flagship Speech2Text (models/asr_model.py:flagship_config,
random weights from a seeded torch.Generator), decodes the traffic of
bench.py:128-133 (8 synthetic 15 s utterances, beam 10, pre-beam 30,
ctc_weight 0.3, max_len 96) once to warm up, then once more under
torch.profiler. Prints one JSON line: the unprofiled host-clock seconds of
encode and search (each ended by a synchronise), the profiled decode's
device busy time (sum of kernel times) and idle share, kernel launches per
decode, host time inside the CTC prefix scorer and the decoder step (of
the profiled run), and the top kernels by device time. Needs a CUDA device.
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
from torch.profiler import ProfilerActivity, profile, record_function

from ..decode import beam, ctc_prefix
from ..models.asr_model import ASRModel, flagship_config
from ..models.transformer import TransformerDecoder
from ..tasks.asr import Speech2Text
from ..utils.params import init_random_

N_UTT, UTT_SECONDS, FS = 8, 15, 16000
BEAM, CTC_WEIGHT, MAX_LEN = 10, 0.3, 96


def _labelled(fn, label):
    def wrapped(*args, **kwargs):
        with record_function(label):
            return fn(*args, **kwargs)
    return wrapped


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the JSON to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_decode: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    cfg = flagship_config()
    state = init_random_(ASRModel(dataclasses.replace(cfg, dtype="float32"),
                                  device="cpu"), 0).state_dict()
    tokens = ["<blank>", "<unk>"] + [f"w{i}" for i in range(
        cfg.vocab_size - 3)] + ["<sos/eos>"]
    s2t = Speech2Text(cfg, state, tokens, token_type="word", max_len=MAX_LEN,
                      beam_size=BEAM, ctc_weight=CTC_WEIGHT, device="cuda")
    rng = np.random.RandomState(0)
    speeches = [rng.randn(FS * UTT_SECONDS).astype(np.float32) * 0.1
                for _ in range(N_UTT)]
    s2t.decode_batch(speeches)  # warm-up

    # Unprofiled host-clock split of the same work Speech2Text does.
    buf, lens = s2t.pad_batch(speeches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        hs, hl = s2t.model.encode(torch.from_numpy(buf).cuda(),
                                  torch.from_numpy(lens).cuda())
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    beam.batch_beam_search(s2t.model, hs, hl, beam.BeamSearchConfig(
        beam_size=BEAM, max_len=MAX_LEN, ctc_weight=CTC_WEIGHT))
    torch.cuda.synchronize()
    t2 = time.perf_counter()

    ctc_prefix.score_candidates = _labelled(ctc_prefix.score_candidates,
                                            "ctc_prefix.score_candidates")
    TransformerDecoder.step = _labelled(TransformerDecoder.step,
                                        "decoder.step")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t3 = time.perf_counter()
        s2t.decode_batch(speeches)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
    labels = ("ctc_prefix.score_candidates", "decoder.step")
    # record_function also leaves a device-side annotation per range; only
    # real kernels count as device work.
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.key not in labels]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    host_s = {k: 0.0 for k in labels}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name in host_s:
            host_s[e.name] += e.time_range.elapsed_us() / 1e6
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    wall = t4 - t3
    result = {
        "card": card,
        "audio_s": N_UTT * UTT_SECONDS,
        "encode_s": t1 - t0,
        "search_s": t2 - t1,
        "profiled_wall_s": wall,
        "device_busy_ms": busy_ms,
        "idle_share_profiled": 1.0 - busy_ms / 1e3 / wall,
        "kernel_launches": sum(e.count for e in kernels),
        "profiled_host_s_in": host_s,
        "top_kernels": [{"name": e.key[:60], "count": e.count,
                         "ms": e.self_device_time_total / 1e3} for e in top],
    }
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
