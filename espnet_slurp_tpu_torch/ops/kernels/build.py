"""Builds and loads the port's CUDA kernels (``espnet_slurp_tpu_torch/csrc``).

Every ``.cu`` source is compiled by its own ``nvcc`` process (all started
together) for ``sm_90a`` and linked into one shared library with a plain C
interface, loaded through ``ctypes``. The build happens at first use, into
``build/kernels/<hash of the sources and flags>/`` beside the package, so a
fresh checkout builds itself and an edited source rebuilds. No fallback: a
missing ``nvcc`` or a failed build raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
LIB_NAME = "libespnet_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v", "-lineinfo")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                           "the port's kernels")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compiles the kernels if this source hash has no library yet; returns
    the library's path. The compiler's output (``-Xptxas=-v``: registers,
    shared memory, spills per kernel) is kept in ``build.log`` beside it."""
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    nvcc = _nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=BUILD_ROOT, prefix="tmp-"))
    try:
        sources = sorted(CSRC.glob("*.cu"))
        procs = []
        for src in sources:
            obj = tmp / (src.stem + ".o")
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log = []
        failed = []
        for src, _, proc in procs:
            text, _ = proc.communicate()
            log.append(f"== {src.name} (exit {proc.returncode})\n{text}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", str(tmp / LIB_NAME), *(str(obj) for _, obj, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(f"== link (exit {link.returncode})\n{link.stdout}")
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + "\n".join(log))
        (tmp / "build.log").write_text("\n".join(log))
        try:
            tmp.rename(out_dir)
        except OSError:  # another process finished the same build first
            if not lib.exists():
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library, with every entry point's C signature set."""
    lib = ctypes.CDLL(str(build()))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    u = ctypes.c_uint
    lib.espnet_fused_ffn_fwd.argtypes = [i, p, p, p, p, p, p, p, i, i, i, i, i,
                                         p, u, f, p]
    lib.espnet_fused_ffn_fwd.restype = i
    lib.espnet_fused_ffn_fwd_splits.argtypes = [i, i, i, i]
    lib.espnet_fused_ffn_fwd_splits.restype = i
    lib.espnet_fused_ffn_takes.argtypes = [i, i, i, i, i]
    lib.espnet_fused_ffn_takes.restype = i
    lib.espnet_fused_ffn_fwd_blocks_per_sm.argtypes = [i, i]
    lib.espnet_fused_ffn_fwd_blocks_per_sm.restype = i
    lib.espnet_fused_ffn_f32_info.argtypes = [i, ctypes.POINTER(i)]
    lib.espnet_fused_ffn_f32_info.restype = i
    lib.espnet_fused_ffn_f32_dw_splits.argtypes = [i, i, i, i, i]
    lib.espnet_fused_ffn_f32_dw_splits.restype = i
    lib.espnet_rel_flash_fwd.argtypes = [i, p, p, p, p, p, p, p, p, i, i, i, i,
                                         f, i, i, p, u, f, p]
    lib.espnet_rel_flash_fwd.restype = i
    lib.espnet_fused_ffn_bwd.argtypes = [i, p, p, p, p, p, p, p, p, p, p, p, p,
                                         i, i, i, i, i, p, u, f, p]
    lib.espnet_fused_ffn_bwd.restype = i
    lib.espnet_fused_ffn_bwd_row_tile.argtypes = []
    lib.espnet_fused_ffn_bwd_row_tile.restype = i
    lib.espnet_rel_flash_bwd.argtypes = [i, p, p, p, p, p, p, p, p, p, p, p,
                                         p, p, p, i, i, i, i, f, i, i, p, u, f,
                                         p]
    lib.espnet_rel_flash_bwd.restype = i
    lib.espnet_rel_flash_dkv_blocks_per_sm.argtypes = [i]
    lib.espnet_rel_flash_dkv_blocks_per_sm.restype = i
    lib.espnet_rel_flash_fwd_blocks_per_sm.argtypes = [i]
    lib.espnet_rel_flash_fwd_blocks_per_sm.restype = i
    lib.espnet_rel_flash_dq_blocks_per_sm.argtypes = [i]
    lib.espnet_rel_flash_dq_blocks_per_sm.restype = i
    lib.espnet_rel_flash_f32_blocks_per_sm.argtypes = [i, i]
    lib.espnet_rel_flash_f32_blocks_per_sm.restype = i
    lib.espnet_ctc_fwd.argtypes = [p, p, p, p, p, p, i, i, i, p]
    lib.espnet_ctc_fwd.restype = i
    lib.espnet_ctc_bwd.argtypes = [p, p, p, p, p, p, p, i, i, i, p]
    lib.espnet_ctc_bwd.restype = i
    lib.espnet_ctc_warp_states.argtypes = []
    lib.espnet_ctc_warp_states.restype = i
    lib.espnet_ctc_info.argtypes = [i, i, ctypes.POINTER(i)]
    lib.espnet_ctc_info.restype = i
    lib.espnet_launch_names.argtypes = [ctypes.c_char_p, i]
    lib.espnet_launch_names.restype = i
    lib.espnet_ctc_head_fwd.argtypes = [i, p, p, p, p, p, p, p, i, i, i, i, i,
                                        i, p]
    lib.espnet_ctc_head_fwd.restype = i
    lib.espnet_ctc_head_bwd.argtypes = [i, p, p, p, p, p, p, p, p, i, p, p, p,
                                        i, i, i, i, i, i, p]
    lib.espnet_ctc_head_bwd.restype = i
    lib.espnet_ctc_head_bwd_row_tile.argtypes = []
    lib.espnet_ctc_head_bwd_row_tile.restype = i
    lib.espnet_ctc_head_plan.argtypes = [i, i, i, i, i, ctypes.POINTER(i)]
    lib.espnet_ctc_head_plan.restype = i
    lib.espnet_ctc_head_info.argtypes = [i, i, ctypes.POINTER(i)]
    lib.espnet_ctc_head_info.restype = i
    lib.espnet_rnnt_fwd.argtypes = [p, p, p, p, p, p, i, i, i, p]
    lib.espnet_rnnt_fwd.restype = i
    lib.espnet_rnnt_bwd.argtypes = [p, p, p, p, p, p, p, p, i, i, i, p]
    lib.espnet_rnnt_bwd.restype = i
    lib.espnet_rnnt_warp_states.argtypes = []
    lib.espnet_rnnt_warp_states.restype = i
    lib.espnet_rnnt_info.argtypes = [i, i, ctypes.POINTER(i)]
    lib.espnet_rnnt_info.restype = i
    lib.espnet_conv_f32_fwd.argtypes = [p] * 13 + [i] * 5 + [f, p]
    lib.espnet_conv_f32_fwd.restype = i
    lib.espnet_conv_f32_bwd.argtypes = [p] * 22 + [i] + [p] * 6 + [i] * 5 + [
        f, p]
    lib.espnet_conv_f32_bwd.restype = i
    lib.espnet_conv_f32_dw_splits.argtypes = [i, i, i]
    lib.espnet_conv_f32_dw_splits.restype = i
    lib.espnet_conv_f32_info.argtypes = [i, i, i, ctypes.POINTER(i)]
    lib.espnet_conv_f32_info.restype = i
    lib.espnet_conv_rows_tile.argtypes = []
    lib.espnet_conv_rows_tile.restype = i
    lib.espnet_conv_bf16_fwd.argtypes = [p] * 12 + [i] * 5 + [f, p]
    lib.espnet_conv_bf16_fwd.restype = i
    lib.espnet_conv_bf16_bwd.argtypes = [p] * 21 + [i] + [p] * 5 + [i] * 5 + [
        f, p]
    lib.espnet_conv_bf16_bwd.restype = i
    lib.espnet_conv_bf16_dw_splits.argtypes = [i, i, i]
    lib.espnet_conv_bf16_dw_splits.restype = i
    lib.espnet_conv_bf16_info.argtypes = [i, i, i, ctypes.POINTER(i)]
    lib.espnet_conv_bf16_info.restype = i
    lib.espnet_philox4x32_10.argtypes = [p, p, i, p]
    lib.espnet_philox4x32_10.restype = i
    lib.espnet_philox_keep_mask.argtypes = [p, u, i, i, i, p, p]
    lib.espnet_philox_keep_mask.restype = i
    lib.espnet_philox_keep_tiles.argtypes = [p, u, i, i, i, p, p]
    lib.espnet_philox_keep_tiles.restype = i
    lib.espnet_error_string.argtypes = [i]
    lib.espnet_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, what: str) -> None:
    """Raises if a C entry point returned a CUDA error code."""
    if code != 0:
        msg = library().espnet_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def launch_counts() -> Dict[str, int]:
    """Every host-side launch count so far (csrc/common.cuh:counted): each
    kernel instance that has launched, by its name with its template
    arguments as the profiler writes it (e.g. ``"ctc_warp::fwd_kernel"``,
    ``"ffn_fwd::fwd_kernel<256, true>"``); an instance not listed has not
    launched."""
    lib = library()
    n = lib.espnet_launch_names(None, 0)
    buf = ctypes.create_string_buffer(n + 1)
    lib.espnet_launch_names(buf, n + 1)
    out = {}
    for line in buf.value.decode().splitlines():
        name, count = line.rsplit("\t", 1)
        out[name] = int(count)
    return out


def launch_count(name: str) -> int:
    """Launches so far of the kernel instance ``name`` (see
    ``launch_counts``)."""
    return launch_counts().get(name, 0)


def launch_delta(before: Dict[str, int], after: Dict[str, int]
                 ) -> Dict[str, int]:
    """{name: launches} between two ``launch_counts()``, the nonzero ones."""
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def build_log() -> str:
    return (build().parent / "build.log").read_text()


# Element types the kernels are instantiated for, by their C dtype code.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def stream_ptr(t: torch.Tensor) -> int:
    """Handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_aligned(name: str, t: torch.Tensor) -> None:
    """The kernels load 16-byte vectors; a view at an odd offset is refused."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary")
