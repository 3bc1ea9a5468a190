"""The port's n-gram path (decode/ngram_train.py, decode/ngram.py,
bin/ngram_compile.py) against the reference's on the CPU: the ARPA text
that train_arpa writes is the reference's byte for byte; ArpaLM's tables
(from text, from .gz and from the .npz cache) are equal, and each side
loads the other's cache; make_ngram_fusion's rows over random two-token
contexts agree within 1e-6, also when the rows are stepped in sequence."""
import gzip

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_slurp_tpu.bin import ngram_compile as j_compile
from espnet_slurp_tpu.decode import ngram as jng
from espnet_slurp_tpu.decode import ngram_train as jtrain
from espnet_slurp_tpu_torch.bin import ngram_compile as p_compile
from espnet_slurp_tpu_torch.decode import ngram as png
from espnet_slurp_tpu_torch.decode import ngram_train as ptrain
import torch_parity  # noqa: F401  (each test worker's CPU threads)

WORDS = [f"t{i}" for i in range(14)]
TOKENS = ["<blank>", "<unk>"] + WORDS + ["<sos/eos>"]
V = len(TOKENS)
SOS = V - 1
FIELDS = png._BINARY_FIELDS + ("v", "max_row")


def _corpus(seed=0, n=60):
    rng = np.random.RandomState(seed)
    # a skewed unigram so that some bigrams and trigrams repeat
    p = rng.dirichlet(np.full(len(WORDS), 0.3))
    return [list(rng.choice(WORDS, size=rng.randint(1, 9), p=p))
            for _ in range(n)]


def _tok2id():
    tok2id = {t: i for i, t in enumerate(TOKENS)}
    tok2id.setdefault("<s>", SOS)
    tok2id.setdefault("</s>", SOS)
    return tok2id


@pytest.fixture(scope="module")
def arpa(tmp_path_factory):
    d = tmp_path_factory.mktemp("ngram")
    sents = _corpus()
    ref = jtrain.train_arpa(sents, d / "ref.arpa", order=3)
    got = ptrain.train_arpa(sents, d / "port.arpa", order=3)
    return d, ref, got


@pytest.mark.parametrize("order,discount", [(3, 0.75), (2, 0.5), (1, 0.75)])
def test_train_arpa_writes_the_references_bytes(tmp_path, order, discount):
    sents = _corpus(seed=order)
    ref = jtrain.train_arpa(sents, tmp_path / "ref.arpa", order=order,
                            discount=discount)
    got = ptrain.train_arpa(sents, tmp_path / "port.arpa", order=order,
                            discount=discount)
    assert got.read_bytes() == ref.read_bytes()
    text = tmp_path / "text"
    text.write_text("".join(f"u{i} {' '.join(s)}\n"
                            for i, s in enumerate(sents)))
    a = jtrain.train_arpa_from_file(text, tmp_path / "ref2.arpa", order=order)
    b = ptrain.train_arpa_from_file(text, tmp_path / "port2.arpa",
                                    order=order)
    assert a.read_bytes() == b.read_bytes()


def test_arpa_tables_and_cache_equal(arpa, tmp_path):
    d, ref_path, got_path = arpa
    gz = tmp_path / "lm.arpa.gz"
    with gzip.open(gz, "wt") as f:
        f.write(got_path.read_text())
    ref = jng.ArpaLM(str(ref_path), _tok2id(), V)
    for lm in (png.ArpaLM(str(got_path), _tok2id(), V),
               png.ArpaLM(str(gz), _tok2id(), V)):
        for k in FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(lm, k)),
                                          np.asarray(getattr(ref, k)), k)
    assert len(ref.tri_ctx) > 10 and ref.max_row > 1
    ref.save_binary(str(tmp_path / "ref.npz"))
    png.ArpaLM(str(got_path), _tok2id(), V).save_binary(
        str(tmp_path / "port"))
    a, b = np.load(tmp_path / "ref.npz"), np.load(tmp_path / "port.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], k)
    # each side loads the other's cache
    for lm in (png.ArpaLM(str(tmp_path / "ref.npz"), _tok2id(), V),
               png.ArpaLM.load_binary(str(tmp_path / "ref.npz")),
               jng.ArpaLM(str(tmp_path / "port.npz"), _tok2id(), V)):
        for k in FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(lm, k)),
                                          np.asarray(getattr(ref, k)), k)
    with pytest.raises(ValueError, match="vocab"):
        png.ArpaLM(str(tmp_path / "ref.npz"), _tok2id(), V + 1)


def test_ngram_compile_cli_matches(arpa, tmp_path):
    d, _, got_path = arpa
    tokens = tmp_path / "tokens.txt"
    tokens.write_text("\n".join(TOKENS) + "\n")
    args = ["--arpa", str(got_path), "--tokens", str(tokens), "--output"]
    assert j_compile.main(args + [str(tmp_path / "ref.npz")]) == 0
    assert p_compile.main(args + [str(tmp_path / "port.npz")]) == 0
    a, b = np.load(tmp_path / "ref.npz"), np.load(tmp_path / "port.npz")
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], k)


def test_fusion_rows_match(arpa):
    _, _, got_path = arpa
    ref_lm = jng.ArpaLM(str(got_path), _tok2id(), V)
    lm = png.ArpaLM(str(got_path), _tok2id(), V)
    jstep, jinit = jng.make_ngram_fusion(ref_lm, SOS)
    pstep, pinit = png.make_ngram_fusion(lm, SOS, device="cpu")
    rng = np.random.RandomState(3)
    n = 64
    # random contexts, among them sos and the tokens that never occur
    c1 = rng.randint(0, V, n)
    c2 = rng.randint(0, V, n)
    c1[:4], c2[:4] = SOS, SOS
    ref, _ = jstep(jnp.asarray(c2), {"c1": jnp.zeros(n, jnp.int32),
                                     "c2": jnp.asarray(c1)})
    got, st = pstep(torch.from_numpy(c2), {"c1": torch.zeros(n).long(),
                                           "c2": torch.from_numpy(c1)})
    assert got.dtype == torch.float32 and got.shape == (n, V)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=1e-6)
    assert torch.equal(st["c1"], torch.from_numpy(c1))
    # stepped in sequence from lm_init, as the beam search drives it
    jst, pst = jinit(n), pinit(n)
    for _ in range(5):
        y = rng.randint(0, V, n)
        ref, jst = jstep(jnp.asarray(y), jst)
        got, pst = pstep(torch.from_numpy(y), pst)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6,
                                   rtol=1e-6)


SMALL_ARPA = """\\data\\
ngram 1=5
ngram 2=4
ngram 3=2

\\1-grams:
-1.0\t<s>\t-0.30103
-0.60206\ta\t-0.15
-0.69897\tb\t-0.2
-1.30103\tc\t0.0
-1.0\t</s>

\\2-grams:
-0.30103\t<s> a\t-0.1
-0.52\ta b\t-0.05
-0.7\tb a\t0.0
-0.9\tb c

\\3-grams:
-0.2\t<s> a b
-0.4\ta b c

\\end\\
"""


def test_context_keys_past_int32_stay_exact(tmp_path):
    """At V 60,000 a trigram context key c1 * V + c2 passes 2^31 (ids
    50,001-50,003): the port keeps the keys int64, so the rows keep the
    ARPA's trigrams and backoffs, checked against the ARPA by hand."""
    path = tmp_path / "small.arpa"
    path.write_text(SMALL_ARPA)
    v = 60000
    a, b, c, s = 50001, 50002, 50003, v - 1
    lm = png.ArpaLM(str(path), {"a": a, "b": b, "c": c, "<s>": s, "</s>": s},
                    v)
    step, init = png.make_ngram_fusion(lm, s, device="cpu")
    assert int(a) * v + b > 2 ** 31
    row, _ = step(torch.tensor([b, b]), {"c1": torch.tensor([0, 0]),
                                         "c2": torch.tensor([a, s])})
    l10 = np.log(10.0)
    # (a, b) -> c: the trigram; (a, b) -> a: bo(a b) + p(a | b)
    np.testing.assert_allclose(float(row[0, c]), -0.4 * l10, rtol=1e-6)
    np.testing.assert_allclose(float(row[0, a]), (-0.05 - 0.7) * l10,
                               rtol=1e-6)
    # (<s>, b) -> a: no trigram and no bo(<s> b): p(a | b)
    np.testing.assert_allclose(float(row[1, a]), -0.7 * l10, rtol=1e-6)
