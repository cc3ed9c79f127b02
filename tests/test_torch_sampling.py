"""The port's sampler against the JAX package's (`models/generate.py`).

The two packages draw from different generators (a `torch.Generator` and a
JAX key), so the sampler is held by its support and its distribution, not
by its tokens: the nucleus is the same set of ids as the one JAX draws
from (read from the logits JAX hands `jax.random.categorical`), with the
same logits; 20k draws of each pass a chi-square test of homogeneity at p
>= 1e-3. Greedy decoding is held by tokens.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import chi2_contingency

from ullava_tpu.models import generate as jgen
from ullava_tpu.models import ullava_core as jcore
from torch_port_helpers import random_params
from ullava_tpu_torch.bridge import params_from_jax
from ullava_tpu_torch.models import generate, ullava_core

DRAWS = 20000
P_MIN = 1e-3


def setup_module():
    torch.set_num_threads(1)


def _jax_nucleus(logits, gen, monkeypatch):
    """The logits the JAX sampler draws from, taken where it hands them to
    `jax.random.categorical`."""
    seen = []

    def capture(key, lg, axis=-1):
        seen.append(np.asarray(lg))
        return jnp.argmax(lg, axis=axis)

    with monkeypatch.context() as m:
        m.setattr(jax.random, "categorical", capture)
        jgen.sample_token(jax.random.PRNGKey(0), jnp.asarray(logits), gen)
    return seen[0]


def _logits(rng, B=3, V=64):
    x = (2.0 * rng.standard_normal((B, V))).astype(np.float32)
    # Row 1: a three-way tie at the top-p cutoff of the (1.0, 0.75) case
    # (probabilities 0.524, 0.193, then 0.071 each for ids 2, 3, 4).
    x[1, :] = -4.0
    x[1, :6] = [3.0, 2.0, 1.0, 1.0, 1.0, 0.5]
    return x


CASES = [(0.2, 0.9), (1.0, 0.75), (1.0, 0.5), (0.7, None), (1.3, 0.95), (0.5, 1.0)]


@pytest.mark.parametrize("temperature,top_p", CASES)
@pytest.mark.parametrize("vocab_size", [None, 50])
def test_nucleus_matches_jax(temperature, top_p, vocab_size, monkeypatch):
    logits = _logits(np.random.default_rng(0))
    jg = jgen.GenerateConfig(temperature=temperature, top_p=top_p, vocab_size=vocab_size)
    g = generate.GenerateConfig(temperature=temperature, top_p=top_p, vocab_size=vocab_size)
    ref = _jax_nucleus(logits, jg, monkeypatch)
    got = generate.nucleus_logits(torch.from_numpy(logits), g).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    np.testing.assert_allclose(got[np.isfinite(got)], ref[np.isfinite(ref)], rtol=1e-6)
    if vocab_size is not None:
        assert not np.isfinite(got[:, vocab_size:]).any()
    if (temperature, top_p) == (1.0, 0.75):
        # The tie: ids 2, 3, 4 share the cutoff logit and all stay.
        assert np.isfinite(got[1, :5]).all() and not np.isfinite(got[1, 5:]).any()


def _counts(ids, V):
    return np.bincount(np.asarray(ids).reshape(-1), minlength=V)


@pytest.mark.parametrize("temperature,top_p,row", [(0.2, 0.9, 0), (1.0, 0.75, 1), (1.3, 0.95, 2)])
def test_draw_frequencies_match_jax(temperature, top_p, row, monkeypatch):
    V = 64
    logits = _logits(np.random.default_rng(1), V=V)[row:row + 1]
    g = generate.GenerateConfig(temperature=temperature, top_p=top_p, vocab_size=50)
    jg = jgen.GenerateConfig(temperature=temperature, top_p=top_p, vocab_size=50)
    support = np.isfinite(_jax_nucleus(logits, jg, monkeypatch)[0])

    gen = torch.Generator().manual_seed(0)
    got = generate.sample_token(torch.from_numpy(logits).expand(DRAWS, V), g, gen)
    ref = jgen.sample_token(jax.random.PRNGKey(0), jnp.broadcast_to(jnp.asarray(logits), (DRAWS, V)),
                            jg)
    cg, cr = _counts(got.numpy(), V), _counts(ref, V)
    assert support[cg > 0].all() and support[cr > 0].all()
    # Bins with fewer than 5 expected draws merge into one.
    big = (cg + cr) >= 10
    table = np.stack([cg[big], cr[big]], 1)
    if (cg + cr)[~big].sum():
        table = np.vstack([table, [cg[~big].sum(), cr[~big].sum()]])
    if table.shape[0] > 1:
        p = chi2_contingency(table.T)[1]
        assert p >= P_MIN, (p, table.T)


def test_temperature_zero_is_argmax(monkeypatch):
    logits = _logits(np.random.default_rng(2), B=4, V=64)
    logits[3, 7] = logits[3, 9] = logits[3].max() + 1.0  # a tie: the first wins
    g = generate.GenerateConfig(temperature=0.0, top_p=0.5, vocab_size=60)
    got = generate.sample_token(torch.from_numpy(logits), g)
    ref = jgen.sample_token(jax.random.PRNGKey(0), jnp.asarray(logits),
                            jgen.GenerateConfig(temperature=0.0, top_p=0.5, vocab_size=60))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got.numpy(), logits[:, :60].argmax(-1))
    assert got.dtype == torch.int32


def test_config_fields_and_defaults_match_jax():
    names = [f.name for f in dataclasses.fields(jgen.GenerateConfig)]
    assert names == [f.name for f in dataclasses.fields(generate.GenerateConfig)]
    j, t = jgen.GenerateConfig(), generate.GenerateConfig()
    assert all(getattr(j, n) == getattr(t, n) for n in names)
    assert t.temperature == 0.2 and t.top_p is None and t.capture_hidden and t.do_sample
    assert not generate.GenerateConfig(temperature=0.0).do_sample


def test_seed_gives_the_same_draws_twice():
    """A seeded generator repeats its draws, in `sample_token` and through
    `generate`; without one, `generate` seeds 0 (the JAX `PRNGKey(0)`)."""
    logits = torch.from_numpy(_logits(np.random.default_rng(3), B=2, V=64)).repeat(500, 1)
    g = generate.GenerateConfig(temperature=1.0, top_p=0.95)
    a = generate.sample_token(logits, g, torch.Generator().manual_seed(7))
    b = generate.sample_token(logits, g, torch.Generator().manual_seed(7))
    c = generate.sample_token(logits, g, torch.Generator().manual_seed(8))
    assert torch.equal(a, b) and not torch.equal(a, c)

    jcfg = jcore.UllavaCoreConfig.tiny()
    cfg = ullava_core.UllavaCoreConfig.tiny()
    params = params_from_jax(random_params(jcore.init_params, jcfg, seed=4), device="cpu")
    rng = np.random.default_rng(4)
    ids = rng.integers(5, 140, size=(2, 10))
    ids[:, 1] = cfg.img_start_id
    ids[:, 2:6] = 3
    ids[:, 6] = cfg.img_end_id
    batch = dict(input_ids=torch.as_tensor(ids), prompt_lens=torch.tensor([10, 8], dtype=torch.int32),
                 images=torch.as_tensor(rng.standard_normal((2, 28, 28, 3)).astype(np.float32)))
    gc = generate.GenerateConfig(max_new_tokens=6, temperature=1.5, top_p=0.95)
    runs = [generate.generate(params, cfg, gc, generator=torch.Generator().manual_seed(s), **batch)
            for s in (11, 11, 12)]
    default = [generate.generate(params, cfg, gc, **batch) for _ in range(2)]
    assert torch.equal(runs[0]["sequences"], runs[1]["sequences"])
    assert not torch.equal(runs[0]["sequences"], runs[2]["sequences"])
    assert torch.equal(default[0]["sequences"], default[1]["sequences"])
    assert torch.equal(default[0]["sequences"],
                       generate.generate(params, cfg, gc, generator=torch.Generator().manual_seed(0),
                                         **batch)["sequences"])
