"""The port's binding of the C++ lexicon CTC beam decoder
(speech2text_torch/runtime_binding.py, on the library it builds itself
with g++ into build/runtime/) against tests/test_runtime_binding.py's
cases and against the JAX package's binding (speech2text_tpu/
runtime_binding.py) loaded on the same library: texts with and without a
synthetic ARPA LM over a batch of unequal lengths. `ctc_inference` with
`ctc_lexicon_beam_search` is held to JAX's report in
tests/test_torch_conformer_inference.py."""

import numpy as np
import pytest
import torch

from speech2text_torch import runtime_binding as trb

# token ids: 0=<blank>, 1=t, 2=h, 3=e, 4=c, 5=a
LEXICON = {"the": [1, 2, 3], "cat": [4, 5, 1], "tea": [1, 3, 5]}
ARPA = ("\\data\\\nngram 1=5\nngram 2=2\n\n\\1-grams:\n"
        "-0.5 <s> -0.3\n-1.0 </s>\n-0.7 the -0.2\n-0.9 cat -0.1\n"
        "-1.5 tea -0.1\n\n\\2-grams:\n-0.3 <s> the\n-0.2 the cat\n\n"
        "\\end\\\n")


def peaked(ids, V=6):
    em = np.full((len(ids), V), np.log(0.01), np.float32)
    em[np.arange(len(ids)), ids] = np.log(0.95)
    return em


def _tie():
    em = peaked([1, 2, 3, 0, 4, 5, 1])[None]
    em[0, 6, 1] = np.log(0.45)
    em[0, 6, 3] = np.log(0.45)
    return em


# name → (log-probs, lengths, use the LM, lm_weight, what the case checks)
CASES = {
    "no_lm": (peaked([1, 2, 3, 0, 4, 5, 1])[None], [7], False, 1.0,
              lambda out: out == ["the cat"]),
    "vocabulary": (peaked([1, 3, 5])[None], [3], False, 1.0,
                   lambda out: out == ["tea"]),
    "arpa_lm": (_tie(), [7], True, 2.0,
                lambda out: out[0].startswith("the")),
    "batch_lengths": (np.stack([peaked([1, 2, 3, 0, 0, 0, 0]),
                                peaked([4, 5, 1, 0, 1, 3, 5])]), [3, 7],
                      False, 1.0, lambda out: out == ["the", "cat tea"]),
}


@pytest.fixture(scope="module")
def jax_binding():
    """JAX's binding, pointed at the library the port built."""
    from speech2text_tpu import runtime_binding as jrb
    saved = jrb._LIB_PATHS
    jrb._LIB_PATHS = (str(trb.build_library()),)
    yield jrb
    jrb._LIB_PATHS = saved


@pytest.fixture(scope="module")
def arpa(tmp_path_factory):
    path = tmp_path_factory.mktemp("lm") / "lm.arpa"
    path.write_text(ARPA)
    return str(path)


@pytest.mark.parametrize("case", sorted(CASES))
def test_binding_cases_match_jax(jax_binding, arpa, case):
    em, lens, use_lm, lm_weight, check = CASES[case]
    kw = dict(arpa_path=arpa if use_lm else None, lm_weight=lm_weight)
    got = trb.CtcLexiconBeamDecoding(LEXICON, **kw).decode(
        torch.from_numpy(em), torch.tensor(lens))
    assert check(got), got
    want = jax_binding.CtcLexiconBeamDecoding(LEXICON, **kw).decode(
        em, np.asarray(lens))
    assert got == want


@pytest.mark.parametrize("use_lm", [False, True])
def test_random_batch_matches_jax(jax_binding, arpa, use_lm):
    rng = np.random.default_rng(int(use_lm))
    B, T, V = 6, 40, 6
    logits = rng.standard_normal((B, T, V)).astype(np.float32) * 3.0
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    lens = np.array([40, 33, 17, 40, 5, 26])
    kw = dict(arpa_path=arpa if use_lm else None, beam_size=8,
              lm_weight=0.7, word_score=0.3)
    got = trb.CtcLexiconBeamDecoding(LEXICON, **kw).decode(
        torch.from_numpy(lp), torch.from_numpy(lens))
    want = jax_binding.CtcLexiconBeamDecoding(LEXICON, **kw).decode(
        lp, lens)
    assert sum(len(t.split()) for t in got) > 5
    assert got == want


def test_build_raises_without_compiler(monkeypatch, tmp_path):
    monkeypatch.setattr(trb, "BUILD_DIR", tmp_path / "runtime")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        trb.build_library()
    assert not list((tmp_path / "runtime").glob("*.so"))
