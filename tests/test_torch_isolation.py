"""The port stands alone: espnet_slurp_tpu_torch imports neither JAX/flax nor
anything of espnet_slurp_tpu (only the tests import both), and neither
``transformers`` nor ``safetensors`` (models/hf_transformer.py reads HF
model directories itself)."""
import pathlib
import re
import subprocess
import sys

import pytest

import espnet_slurp_tpu_torch
import torch_parity  # noqa: F401  (each test worker's CPU threads)

PKG = pathlib.Path(espnet_slurp_tpu_torch.__file__).parent

# Counts only modules the port's imports add, so an interpreter that loads
# something at start-up cannot blame the port.
_PROBE = """
import importlib, pkgutil, sys
before = set(sys.modules)
import espnet_slurp_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in set(sys.modules) - before
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "espnet_slurp_tpu",
                                    "transformers", "safetensors"))
print(len(names), bad)
"""


def test_importing_every_module_loads_no_jax_and_no_reference():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], capture_output=True, text=True,
        cwd=PKG.parent, timeout=300)
    assert proc.returncode == 0, proc.stderr
    n, bad = proc.stdout.strip().split(" ", 1)
    assert int(n) >= 20, proc.stdout
    assert bad == "[]", bad


_REFERENCE_IMPORT = re.compile(
    r"^\s*(from|import)\s+(espnet_slurp_tpu(?!_torch)\b|jax\b|flax\b)", re.M)
SMOKE = PKG.parent / "chip_smoke.py"


def test_no_source_names_the_reference_package():
    offenders = [str(p.relative_to(PKG)) for p in PKG.rglob("*.py")
                 if _REFERENCE_IMPORT.search(p.read_text())]
    assert offenders == []


_HF_IMPORT = re.compile(r"^\s*(from|import)\s+(transformers|safetensors)\b",
                        re.M)


def test_no_source_imports_transformers_or_safetensors():
    offenders = [str(p.relative_to(PKG)) for p in PKG.rglob("*.py")
                 if _HF_IMPORT.search(p.read_text())]
    assert offenders == []
    assert not _HF_IMPORT.search(SMOKE.read_text())


def test_chip_smoke_imports_neither_jax_nor_the_reference():
    assert not _REFERENCE_IMPORT.search(SMOKE.read_text())


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """Without CUDA, or alone in a directory, chip_smoke.py exits non-zero
    and prints no result line."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the script would run in full")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(SMOKE.read_text())
    for path in (SMOKE, alone):
        proc = subprocess.run([sys.executable, str(path)], capture_output=True,
                              text=True, cwd=path.parent, timeout=300)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


# The training runtime, the data pipeline, the tasks, the recipe and the
# CLIs: host-side code (much of it copied from reference modules that import
# numpy only) and the transducer's beam searches.
RUNTIME_AND_CLI = tuple("espnet_slurp_tpu_torch." + m for m in (
    "native", "utils.config", "utils.metrics", "data.fileio", "data.cleaner",
    "data.collate", "data.mini_corpus", "data.sampler", "data.dataset",
    "data.prefetch", "data.tokenizer", "train.reporter", "train.checkpoint",
    "train.trainer", "tasks.asr", "bin.asr_train", "bin.asr_inference",
    "ops.resample", "train.collect_stats", "bin.aggregate_stats_dirs",
    "recipe.asr_pipeline", "bin.pack", "tasks.asr_transducer",
    "decode.transducer_beam", "bin.asr_transducer_train",
    "bin.asr_transducer_inference",
    # The encoder options: the registry (a copy of the reference's, which
    # imports nothing of JAX), the routed MoE, the frontends and the
    # optimizers.
    "utils.registry", "models.moe", "models.conformer", "models.transformer",
    "ops.frontend", "train.optim", "train.state",
    # Contextual biasing and MBR: the knowledge base (a copy of the
    # reference's numpy module), TCPGen, the biased search, the KB-aware
    # transducer and the MBR term.
    "slu", "slu.kb", "models.tcpgen", "decode.beam", "models.asr_model",
    "models.transducer", "train.mbr",
    # SLU: BERT / GPT-2 and the HF bridge, the two-pass model, its scoring
    # and corpus (copies of the reference's numpy modules), the task, its
    # CLIs and the recipe.
    "models.hf_transformer", "slu.model", "slu.metrics", "slu.mini_corpus",
    "tasks.slu", "bin.slu_train", "bin.slu_inference",
    "recipe.prepare_slurp", "recipe.slu_pipeline",
    # The language models and fusion: the LMs, their task and CLIs, the
    # n-gram scorer and trainer (copies of the reference's host code beside
    # torch scorers), the word-level fusions and the state tree helper.
    "models.lm", "tasks.lm", "bin.lm_train", "bin.lm_calc_perplexity",
    "decode.ngram", "decode.ngram_train", "bin.ngram_compile",
    "decode.word_lm", "utils.tree",
    # KA2G: the slot generator and the composite model, the device-resident
    # corpus, chunked iteration, the generic task runner, the bridge and
    # the two recipes (the corpora are copies of the reference's numpy
    # code).
    "slu.generator", "slu.ka2g", "data.resident", "data.chunk_iter",
    "tasks.generic", "utils.params", "recipe.results_run",
    "recipe.ka2g_run",
    # The remaining ASR decoders: streaming (re-encode and incremental)
    # with its CLI, the time-synchronous and lattice decodes, CTC
    # segmentation (a copy of the reference's numpy module) with its CLI,
    # and MaskCTC with its CLI.
    "decode.streaming", "decode.incremental", "bin.asr_inference_streaming",
    "decode.timesync", "decode.lattice", "decode.ctc_segmentation",
    "bin.asr_align", "models.maskctc", "bin.asr_inference_maskctc",
    # The SSL models: wav2vec2 (with its HF weight import, which reads
    # state dicts without transformers), HuBERT with its task and CLI,
    # and the SSL feature dump.
    "models.wav2vec2", "models.hubert", "tasks.hubert", "bin.hubert_train",
    "bin.ssl_dump"))

# Each module of the decoders' slice and the reference file it ports.
DECODER_SLICE = {
    "decode/streaming.py": "espnet_slurp_tpu/decode/streaming.py",
    "decode/incremental.py": "espnet_slurp_tpu/decode/incremental.py",
    "bin/asr_inference_streaming.py":
        "espnet_slurp_tpu/bin/asr_inference_streaming.py",
    "decode/timesync.py": "espnet_slurp_tpu/decode/timesync.py",
    "decode/lattice.py": "espnet_slurp_tpu/decode/lattice.py",
    "decode/ctc_segmentation.py":
        "espnet_slurp_tpu/decode/ctc_segmentation.py",
    "bin/asr_align.py": "espnet_slurp_tpu/bin/asr_align.py",
    "models/maskctc.py": "espnet_slurp_tpu/models/maskctc.py",
    "bin/asr_inference_maskctc.py":
        "espnet_slurp_tpu/bin/asr_inference_maskctc.py",
}


def test_runtime_and_cli_modules_are_among_those_checked():
    """The first test imports every module pkgutil walks; these are among
    them, and none of their sources imports the reference."""
    import pkgutil
    names = {m.name for m in pkgutil.walk_packages(
        espnet_slurp_tpu_torch.__path__, "espnet_slurp_tpu_torch.")}
    assert set(RUNTIME_AND_CLI) <= names, set(RUNTIME_AND_CLI) - names
    for name in RUNTIME_AND_CLI:
        rel = name.split(".", 1)[1].replace(".", "/")
        path = PKG / (rel + ".py")
        if not path.exists():
            path = PKG / rel / "__init__.py"
        assert not _REFERENCE_IMPORT.search(path.read_text()), name


def _docstring(path):
    import ast
    return ast.get_docstring(ast.parse(path.read_text())) or ""


@pytest.mark.parametrize("rel", sorted(DECODER_SLICE))
def test_each_decoder_module_names_the_reference_file_it_ports(rel):
    """Each module of the decoders' slice says in its docstring which
    reference file it ports, and that file exists."""
    ref = DECODER_SLICE[rel]
    assert ref in " ".join(_docstring(PKG / rel).split()), rel
    assert (PKG.parent / ref).exists(), ref


# Each module of the SSL slice and the reference file it ports.
SSL_SLICE = {
    "models/wav2vec2.py": "espnet_slurp_tpu/models/wav2vec2.py",
    "models/hubert.py": "espnet_slurp_tpu/models/hubert.py",
    "tasks/hubert.py": "espnet_slurp_tpu/tasks/hubert.py",
    "bin/hubert_train.py": "espnet_slurp_tpu/bin/hubert_train.py",
    "bin/ssl_dump.py": "espnet_slurp_tpu/bin/ssl_dump.py",
}


@pytest.mark.parametrize("rel", sorted(SSL_SLICE))
def test_each_ssl_module_names_the_reference_file_it_ports(rel):
    ref = SSL_SLICE[rel]
    assert ref in " ".join(_docstring(PKG / rel).split()), rel
    assert (PKG.parent / ref).exists(), ref
