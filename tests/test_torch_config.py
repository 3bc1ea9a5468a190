"""The port's configs take every field the reference's take.

Field names, defaults and type annotations of each config dataclass
against its reference class (``fused_conv`` is the one port-only field,
utils/config.py:PORT_ONLY); every asr-task ``conf/train_*.yaml`` and
``conf/train_transducer.yaml`` load in the port and either build or raise
NotImplementedError naming a ROADMAP.md queue 1 item; a config.yaml the
reference writes loads in the port, and the loader still refuses an
unknown key."""
import dataclasses
from pathlib import Path

import pytest
import torch

from espnet_slurp_tpu.models import asr_model as jmodel
from espnet_slurp_tpu.models import transducer as jtd
from espnet_slurp_tpu.models.wav2vec2 import Wav2Vec2Config as JW2V
from espnet_slurp_tpu.ops import frontend as jfront
from espnet_slurp_tpu.slu import model as jslu
from espnet_slurp_tpu.tasks import asr as jasr
from espnet_slurp_tpu.tasks import asr_transducer as jtask
from espnet_slurp_tpu.tasks import slu as jslutask
from espnet_slurp_tpu.train import mbr as jmbr
from espnet_slurp_tpu.train import optim as joptim
from espnet_slurp_tpu.utils.config import save_yaml as j_save_yaml
from espnet_slurp_tpu.utils.config import to_dict as j_to_dict
from espnet_slurp_tpu_torch.models import asr_model as pmodel
from espnet_slurp_tpu_torch.models import transducer as ptd
from espnet_slurp_tpu_torch.ops import frontend as pfront
from espnet_slurp_tpu_torch.slu import model as pslu
from espnet_slurp_tpu_torch.tasks import asr as pasr
from espnet_slurp_tpu_torch.tasks import asr_transducer as ptask
from espnet_slurp_tpu_torch.tasks import slu as pslutask
from espnet_slurp_tpu_torch.train import optim as poptim
from espnet_slurp_tpu_torch.utils.config import to_dict
import torch_parity  # noqa: F401  (each test worker's CPU threads)

CONF = Path(__file__).resolve().parent.parent / "conf"
PAIRS = [
    (pmodel.ASRConfig, jmodel.ASRConfig),
    (pmodel.Wav2Vec2Config, JW2V),
    (pfront.FrontendConfig, jfront.FrontendConfig),
    (ptd.TransducerConfig, jtd.TransducerConfig),
    (pasr.ASRTaskConfig, jasr.ASRTaskConfig),
    (pasr.DataConfig, jasr.DataConfig),
    (poptim.OptimConfig, joptim.OptimConfig),
    (pasr.MBRConfig, jmbr.MBRConfig),
    (ptask.TransducerTaskConfig, jtask.TransducerTaskConfig),
    (pslu.SLUConfig, jslu.SLUConfig),
    (pslutask.SLUTaskConfig, jslutask.SLUTaskConfig),
]


def _fields(cls):
    return {f.name: f for f in dataclasses.fields(cls)}


def _plain(value):
    """A default as the YAML would hold it (nested configs as dicts)."""
    if dataclasses.is_dataclass(value):
        return {f.name: _plain(getattr(value, f.name))
                for f in dataclasses.fields(value)
                if not f.metadata.get("port_only")}
    if isinstance(value, (list, tuple)):
        return [_plain(x) for x in value]
    return value


@pytest.mark.parametrize("port,ref", PAIRS,
                         ids=[p.__name__ for p, _ in PAIRS])
def test_fields_defaults_and_types_equal_the_references(port, ref):
    pf, jf = _fields(port), _fields(ref)
    port_only = {n for n, f in pf.items() if f.metadata.get("port_only")}
    assert port_only == ({"fused_conv"} if port is pmodel.ASRConfig
                         else set())
    assert sorted(set(pf) - port_only) == sorted(jf)
    for name, f in jf.items():
        assert pf[name].type == f.type, name
        assert _plain(getattr(port(), name)) == _plain(
            getattr(ref(), name)), name


def test_the_loader_still_refuses_an_unknown_key():
    with pytest.raises(ValueError, match="unknown config keys"):
        pasr.load_task_config(None, {"model": {"encoders": "conformer"}})
    with pytest.raises(ValueError, match="unknown config keys"):
        ptask.load_transducer_config(None, {"model": {"asr": {"x": 1}}})


# conf/*.yaml of the ASR task: (file, None if it builds, else the queue 1
# item its NotImplementedError names).
ASR_RECIPES = [
    ("train_ls100_conformer.yaml", None),
    ("train_streaming.yaml", None),
    ("train_moe.yaml", None),
    ("train_mbr_kb.yaml", None),
    ("train_asr_pipeline.yaml", "item 17"),
]


def test_every_asr_recipe_is_listed():
    """Every conf/train_*.yaml is an ASR recipe above, the transducer's, or
    the SLU task's (test_slu_recipe_loads_and_builds)."""
    names = {p.name for p in CONF.glob("train_*.yaml")}
    assert names == {n for n, _ in ASR_RECIPES} | {
        "train_transducer.yaml", "train_slu_tcpgen_gcn.yaml"}


@pytest.mark.parametrize("name,item", ASR_RECIPES)
def test_asr_recipe_loads_then_builds_or_names_its_item(name, item):
    cfg = pasr.load_task_config(str(CONF / name))
    ref = jasr.load_task_config(str(CONF / name))
    assert to_dict(cfg) == j_to_dict(ref)
    if item is not None:
        with pytest.raises(NotImplementedError, match=item):
            pasr.refuse_unported(cfg)
        with pytest.raises(NotImplementedError, match=item):
            pasr.ASRTask.train(dataclasses.replace(cfg, exp_dir="unused"),
                               device="cpu")
        return
    pasr.refuse_unported(cfg)
    model = pasr.ASRTask.build_model(cfg.model, cfg.model_arch, "cpu")
    assert model.encoder.num_blocks == cfg.model.num_encoder_blocks == 12
    assert model.ctc_proj.out_features == cfg.model.vocab_size == 5000
    assert (cfg.model.chunk_size, cfg.model.use_mvn) == {
        "train_streaming.yaml": (40, "global"),
        "train_mbr_kb.yaml": (0, "utterance")}.get(name, (0, "global"))
    # train_mbr_kb.yaml: TCPGen (gcn over the trie) and the MBR term
    assert hasattr(model, "tcpgen") == cfg.model.use_tcpgen \
        == (name == "train_mbr_kb.yaml")
    assert (cfg.mbr.weight > 0) == (name == "train_mbr_kb.yaml")


@pytest.mark.parametrize("encoder", ["gcn", "gat", "sage", "treelstm"])
def test_use_tcpgen_builds_with_every_tree_encoder(encoder):
    """ASRConfig(use_tcpgen=True) builds with each tree encoder, its TCPGen
    parameters those of the reference's flax tree at the same widths."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from espnet_slurp_tpu.models.tcpgen import TCPGen as JTCPGen
    from espnet_slurp_tpu_torch.utils.params import flax_to_torch
    cfg = pasr.load_task_config(None, {"model": {
        "use_tcpgen": True, "tcpgen_tree_encoder": encoder, "d_model": 32,
        "n_head": 2, "vocab_size": 40, "tcpgen_gcn_layers": 3}})
    pasr.refuse_unported(cfg)
    model = pmodel.ASRModel(cfg.model, device="cpu")
    from espnet_slurp_tpu_torch.slu.kb import build_trie
    t8 = build_trie([[1, 2], [3]], pad_nodes_multiple=8)
    trie = {k: jnp.asarray(getattr(t8, k[5:])) for k in (
        "trie_token", "trie_children_tok", "trie_children_node",
        "trie_n_children")}

    def fwd(m, x):
        ptr, kb = m(x[:3], jnp.zeros(3, jnp.int32), trie,
                    m.encode_tree(x, trie))
        return m.gen_prob(x[:3], kb, jnp.zeros(3, jnp.int32))

    jp = JTCPGen(32, 40, 3, tree_encoder=encoder).init(
        jax.random.PRNGKey(0), jnp.ones((8, 32)), method=fwd)["params"]
    want = {f"tcpgen.{k}": tuple(v.shape) for k, v in flax_to_torch(
        jax.tree.map(np.asarray, jp)).items()}
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()
           if k.startswith("tcpgen.")}
    assert got == want


def test_slu_recipe_loads_and_builds():
    """conf/train_slu_tcpgen_gcn.yaml loads in the port to the reference's
    values, field by field, and builds: two-pass with the BERT postdecoder
    (4 x d_ff 1024) and 2 deliberation blocks over the 12 x 256 bf16
    Conformer, TCPGen off in the SLU model although the yaml sets
    use_tcpgen (ROADMAP.md queue 3)."""
    name = str(CONF / "train_slu_tcpgen_gcn.yaml")
    cfg = pslutask.load_slu_config(name)
    assert to_dict(cfg) == j_to_dict(jslutask.load_slu_config(name))
    pslutask.refuse_unported_slu(cfg)
    m = cfg.model
    assert (m.two_pass, m.postdecoder, m.text_encoder_blocks,
            m.text_encoder_d_ff, m.deliberation_blocks) == (
        True, "bert", 4, 1024, 2)
    a = m.asr
    assert (a.d_model, a.num_encoder_blocks, a.d_ff, a.num_decoder_blocks,
            a.dtype, a.dropout_rate, a.use_tcpgen,
            a.tcpgen_tree_encoder) == (256, 12, 2048, 6, "bfloat16", 0.1,
                                       True, "gcn")
    assert (cfg.optim.scheduler, cfg.data.batch_type, cfg.data.batch_bins,
            cfg.data.token_type) == ("warmuplr", "numel", 8_000_000, "bpe")
    model = pslu.SLUModel(dataclasses.replace(
        m, transcript_vocab_size=100), device="cpu")
    assert type(model.text_encoder).__name__ == "BertPostdecoder"
    assert model.text_encoder.bert.cfg.num_hidden_layers == 4
    assert model.deliberation.num_blocks == 2
    assert model.asr.encoder.num_blocks == 12
    assert not any(k.startswith("asr.tcpgen") for k in model.state_dict())
    with pytest.raises(ValueError, match="unknown config keys"):
        pslutask.load_slu_config(name, {"model": {"postdecoders": "bert"}})


def test_transducer_recipe_loads_and_builds():
    cfg = ptask.load_transducer_config(str(CONF / "train_transducer.yaml"))
    ref = jtask.load_transducer_config(str(CONF / "train_transducer.yaml"))
    assert to_dict(cfg) == j_to_dict(ref)
    ptask.refuse_unported_transducer(cfg)
    model = ptd.TransducerModel(cfg.model, device="cpu")
    a = cfg.model.asr
    assert (a.d_model, a.num_encoder_blocks, a.dtype, a.dropout_rate) == (
        256, 12, "bfloat16", 0.1)
    assert (cfg.model.pred_dim, cfg.model.joint_dim,
            cfg.model.aux_ctc_weight) == (256, 256, 0.3)
    assert model.joint.lin_out.out_features == a.vocab_size


# The ids keep the cases' names. The E-Branchformer, the LAS decoder, the
# linear pre-encoder and the SSL dump's layer weighting (override0-3) are
# ported since: each builds at micro widths and takes one training step
# (their parity with the reference: tests/test_torch_{branchformer,
# rnn_conv_decoders,pre_post_encoders,ssl}.py).
@pytest.mark.parametrize("override,match", [
    pytest.param({"encoder": "ebranchformer"}, None,
                 id="override0-item 15"),
    pytest.param({"decoder": "rnn"}, None, id="override1-item 15"),
    pytest.param({"preencoder": "linear"}, None, id="override2-item 15"),
    pytest.param({"ssl_num_layers": 2, "input_feats": True}, None,
                 id="override3-item 15"),
    pytest.param({"use_tcpgen": True}, None, id="override4-None"),
    pytest.param({"use_wpe": True}, "items 15 and 16",
                 id="override5-items 15 and 16"),
    pytest.param({"num_ref": 2}, "items 15 and 16",
                 id="override6-items 15 and 16"),
])
def test_unported_model_values_raise_naming_their_item(override, match):
    cfg = pasr.load_task_config(None, {"model": override})
    if match is None and "use_tcpgen" in override:  # ported since
        pasr.refuse_unported(cfg)
        model = pmodel.ASRModel(cfg.model, device="cpu")
        assert model.tcpgen.tree_encoder.__class__.__name__ \
            == "GCNTreeEncoder"
        return
    if match is None:  # ported since: builds and trains a step
        micro = dict(vocab_size=20, d_model=32, n_head=2, d_ff=64,
                     num_encoder_blocks=1, num_decoder_blocks=1,
                     decoder_d_ff=64, kernel_size=7, rnn_decoder_units=16,
                     preencoder_dim=24, specaug=None,
                     frontend={"n_fft": 128, "hop_length": 64, "n_mels": 16})
        cfg = pasr.load_task_config(None, {"model": {**micro, **override}})
        pasr.refuse_unported(cfg)
        model = pasr.ASRTask.init_params(
            pmodel.ASRModel(cfg.model, device="cpu"), 0)
        from espnet_slurp_tpu_torch.train.optim import (OptimConfig,
                                                        build_optimizer)
        from espnet_slurp_tpu_torch.train.state import (TrainState,
                                                        make_train_step)
        tx = build_optimizer(OptimConfig(scheduler="constant", lr=1e-3))
        state = TrainState.create(model, tx, seed=0)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        # an SSL dump [B, T, L, 16] for ssl_num_layers, else waveforms
        ssl = override.get("ssl_num_layers", 0)
        shape, lens = (((2, 40, ssl, 16), [40, 30]) if ssl
                       else ((2, 4096), [4096, 3000]))
        batch = {"speech": torch.randn(*shape) * 0.1,
                 "speech_lengths": torch.tensor(lens),
                 "text": torch.tensor([[3, 4, 5], [6, 7, -1]]),
                 "text_lengths": torch.tensor([3, 2])}
        state, stats = make_train_step(model, tx)(state, batch)
        assert float(stats["loss"]) == float(stats["loss"])  # finite
        after = model.state_dict()
        assert any(not torch.equal(before[k], after[k]) for k in before)
        return
    with pytest.raises(NotImplementedError, match=match):
        pasr.refuse_unported(cfg)
    with pytest.raises(NotImplementedError, match=match):
        pmodel.ASRModel(cfg.model, device="cpu")


# Model values that raised (naming queue 1 item 9) until they were ported:
# each builds now, and the built model has the reference's parameters,
# name for name and shape for shape.
PORTED_MODEL_VALUES = [
    {"input_layer": "linear"},
    {"input_feats": True, "input_feats_dim": 24},
    {"interctc_layers": [3], "interctc_weight": 0.3},
    {"self_conditioning": True, "interctc_layers": [1, 2]},
    {"stochastic_depth_rate": 0.1},
    {"remat_encoder": True},
    {"frontend": {"type": "fused", "win_length": 64}},
    {"frontend": {"delta_order": 2}},
    {"moe_experts": 4, "moe_every": 1},
    {"encoder": "transformer"},
    {"encoder": "longformer", "attention_window": 8},
]


@pytest.mark.parametrize("override", PORTED_MODEL_VALUES)
def test_ported_model_values_build_the_references_parameters(override):
    import jax
    import numpy as np
    from espnet_slurp_tpu_torch.utils.params import flax_to_torch
    tiny = dict(vocab_size=40, d_model=32, n_head=2, d_ff=64,
                num_encoder_blocks=3, num_decoder_blocks=1, decoder_d_ff=64,
                kernel_size=7, specaug=None,
                frontend={"n_fft": 128, "hop_length": 64, "n_mels": 16,
                          **override.get("frontend", {})})
    d = {"model": {**tiny, **{k: v for k, v in override.items()
                              if k != "frontend"}}}
    cfg = pasr.load_task_config(None, d)
    jcfg = jasr.load_task_config(None, d)
    pasr.refuse_unported(cfg)
    port = pmodel.ASRModel(cfg.model, device="cpu")
    jm = jmodel.ASRModel(dataclasses.replace(jcfg.model,
                                             flash_attention="off"))
    if cfg.model.input_feats:
        speech = np.zeros((2, 64, cfg.model.input_feats_dim), np.float32)
        lens = np.asarray([64, 40], np.int32)
    else:
        speech = np.zeros((2, 4096), np.float32)
        lens = np.asarray([4096, 3000], np.int32)
    params = jm.init(jax.random.PRNGKey(0), speech, lens,
                     np.ones((2, 3), np.int32),
                     np.asarray([3, 2], np.int32))["params"]
    ref = flax_to_torch(jax.tree.map(np.asarray, params))
    own = port.state_dict()
    assert sorted(own) == sorted(ref)
    assert all(own[k].shape == ref[k].shape for k in ref)


def test_a_reference_config_yaml_loads_in_the_port(tmp_path):
    """A config.yaml written by the reference's save_yaml, with values away
    from the defaults in every nested config, loads in the port to the same
    values; and a port config written back loads in the reference."""
    ref = jasr.ASRTaskConfig(
        exp_dir="exp/x",
        model=jmodel.ASRConfig(
            vocab_size=77, d_model=64, chunk_size=16, left_chunks=2,
            interctc_layers=(3, 6), rnn_encoder_subsample=(1, 2),
            use_mvn="global", dtype="bfloat16",
            wav2vec2=JW2V(d_model=96, conv_dim=(32, 32)),
            frontend=jfront.FrontendConfig(n_mels=40, delta_order=1)),
        data=jasr.DataConfig(token_type="bpe", bpe_vocab_size=99),
        optim=joptim.OptimConfig(lr=2e-3, scheduler="warmuplr"),
        mbr=jmbr.MBRConfig(weight=0.0, kb_tokens=(4, 5)), max_epoch=7)
    j_save_yaml(ref, tmp_path / "config.yaml")
    port = pasr.load_task_config(str(tmp_path / "config.yaml"))
    assert to_dict(port) == j_to_dict(ref)
    assert port.model.wav2vec2.d_model == 96
    assert port.model.frontend.delta_order == 1
    from espnet_slurp_tpu_torch.utils.config import save_yaml
    save_yaml(port, tmp_path / "back.yaml")
    assert j_to_dict(jasr.load_task_config(str(tmp_path / "back.yaml"))) \
        == j_to_dict(ref)
    tref = jtask.TransducerTaskConfig(model=jtd.TransducerConfig(
        use_tcpgen=True, tcpgen_gcn_layers=3))
    j_save_yaml(tref, tmp_path / "t.yaml")
    tport = ptask.load_transducer_config(str(tmp_path / "t.yaml"))
    assert to_dict(tport) == j_to_dict(tref)
    # the task refuses TCPGen (the reference's task would train a plain
    # transducer under it); the model builds the KB-aware loss
    with pytest.raises(NotImplementedError, match="queue 3"):
        ptask.refuse_unported_transducer(tport)
    kb = ptd.TransducerModel(tport.model, device="cpu")
    assert kb.tcpgen.tree_encoder.num_layers == 3
