"""Parameter bridge: the tiny flagship flax tree loads into the port.

espnet_slurp_tpu_torch/utils/params.py:flax_to_torch must give every key the
port's ASRModel expects (no missing, no unexpected) with matching shapes, and
each conversion rule must hold on its own leaves.
"""
import numpy as np

from espnet_slurp_tpu_torch.models.asr_model import ASRModel
from espnet_slurp_tpu_torch.utils.params import flax_to_torch
from torch_parity import tiny_jax_model, tiny_port_cfg


def test_tiny_flagship_loads_with_no_missing_or_unexpected_keys():
    _, params = tiny_jax_model()
    sd = flax_to_torch(params)
    model = ASRModel(tiny_port_cfg(), device="cpu")
    res = model.load_state_dict(sd, strict=False)
    assert res.missing_keys == [] and res.unexpected_keys == [], res
    own = model.state_dict()
    for k, v in sd.items():
        assert tuple(own[k].shape) == tuple(v.shape), k


def test_conversion_rules():
    _, p = tiny_jax_model()
    sd = flax_to_torch(p)
    enc = p["encoder"]
    blk = enc["block_0"]
    np.testing.assert_array_equal(  # Dense [in, out] -> [out, in]
        sd["encoder.block_0.ff1.w1.weight"].numpy(),
        blk["ff1"]["w1"]["kernel"].T)
    np.testing.assert_array_equal(  # Conv HWIO -> OIHW
        sd["encoder.embed.conv2.weight"].numpy(),
        enc["embed"]["conv2"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(  # depthwise [k, 1, D] -> [D, 1, k]
        sd["encoder.block_0.conv.depthwise.weight"].numpy(),
        blk["conv"]["depthwise"]["kernel"].transpose(2, 1, 0))
    np.testing.assert_array_equal(
        sd["encoder.block_0.norm_mha.weight"].numpy(),
        blk["norm_mha"]["scale"])
    np.testing.assert_array_equal(sd["decoder.embed.weight"].numpy(),
                                  p["decoder"]["embed"]["embedding"])
    np.testing.assert_array_equal(
        sd["encoder.block_0.self_attn.pos_bias_u"].numpy(),
        blk["self_attn"]["pos_bias_u"])
    np.testing.assert_array_equal(sd["ctc_proj.weight"].numpy(),
                                  p["ctc"]["kernel"].T)
