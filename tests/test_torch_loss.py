"""The port's LM losses and data against the JAX package's, on the CPU.

* ``TokenPipeline.batch_at`` equal to the reference's bit for bit over
  several (seed, step, shard, kind, shard count), and its entropy bound;
  the reference's pipeline properties on the port;
* ``softmax_xent`` and ``chunked_xent`` against JAX's (value and grads)
  and against each other (rel 1e-5, as tests/test_models.py holds
  ``chunked_xent`` to the full softmax), including the fallback to one
  chunk when ``loss_chunk`` does not divide the sequence;
* ``registry.loss_fn`` and its grads against ``jax.value_and_grad`` of
  the reference's on JAX-initialised weights carried across by
  ``convert``: TINY and the smoke config of every family (dense,
  LayerNorm/GELU dense, VLM, MoE with its aux loss, MoE with expert
  slices, SSM, hybrid, encdec), under each config's own remat policy:
  loss within rtol 1e-5, every grad leaf within 1e-4 * max|g_leaf| +
  1e-6. Measured worst case: 0.021 of that tolerance (zamba2);
* grads equal across remat "none", "full" and "dots" (bit for bit on the
  CPU: recomputation repeats the same float32 operations).

The JAX side of every comparison is computed in a module fixture,
outside the per-test time budget.
"""
import dataclasses
import functools

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import smoke_config as jax_smoke  # noqa: E402
from repro.configs.base import ShapeSpec  # noqa: E402
from repro.data.pipeline import DataConfig as JaxDataConfig  # noqa: E402
from repro.data.pipeline import TokenPipeline as JaxPipeline  # noqa: E402
from repro.launch.train import TINY as JAX_TINY  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models import registry as jax_registry  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.launch.train import TINY  # noqa: E402
from repro_torch.models import layers, registry  # noqa: E402
from repro_torch.train import tree as T  # noqa: E402
from repro_torch.train.train_step import value_and_grad  # noqa: E402

LOSS_RTOL = 1e-5
GRAD_REL, GRAD_ABS = 1e-4, 1e-6
CASES = ["tiny", "gemma-7b", "starcoder2-7b", "internvl2-76b",
         "deepseek-moe-16b", "grok-1-314b", "mamba2-130m", "zamba2-1.2b",
         "whisper-tiny"]
B, S = 2, 64


def _cfgs(name, **kw):
    j, p = (JAX_TINY, TINY) if name == "tiny" else (jax_smoke(name),
                                                    smoke_config(name))
    return dataclasses.replace(j, **kw), dataclasses.replace(p, **kw)


def _batch(jcfg, seed=1):
    """A (B, S) batch of the family's kind, made by the JAX package."""
    return jax.tree.map(np.asarray, jax_registry.make_batch(
        jcfg, ShapeSpec("x", S, B, "train"), jax.random.PRNGKey(seed)))


def _port_batch(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


# ------------------------------------------------------------ pipeline
@pytest.mark.parametrize("seed,step,shard,n_shards,kind", [
    (0, 0, 0, 1, "markov"), (3, 7, 1, 2, "markov"), (1234, 123, 3, 4,
                                                      "markov"),
    (5, 2, 0, 1, "uniform"), (9, 40, 1, 2, "uniform")])
def test_token_pipeline_equals_reference(seed, step, shard, n_shards, kind):
    kw = dict(vocab=257, seq_len=33, global_batch=8, seed=seed, kind=kind)
    want = JaxPipeline(JaxDataConfig(**kw), n_shards=n_shards).batch_at(
        step, shard)
    pipe = TokenPipeline(DataConfig(**kw), n_shards=n_shards)
    got = pipe.batch_at(step, shard)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])
    assert pipe.entropy_bound_nats() == JaxPipeline(
        JaxDataConfig(**kw)).entropy_bound_nats()


def test_pipeline_deterministic_and_shard_recomputable():
    cfg = DataConfig(vocab=128, seq_len=32, global_batch=8, seed=3)
    p1 = TokenPipeline(cfg, n_shards=2, shard=0)
    p2 = TokenPipeline(cfg, n_shards=2, shard=1)
    b0 = p1.batch_at(7)
    np.testing.assert_array_equal(
        b0["tokens"], TokenPipeline(cfg, n_shards=2, shard=0).batch_at(7)[
            "tokens"])
    np.testing.assert_array_equal(p1.batch_at(7, shard=1)["tokens"],
                                  p2.batch_at(7)["tokens"])
    np.testing.assert_array_equal(b0["tokens"][:, 1:], b0["labels"][:, :-1])
    first = next(iter(p1))
    np.testing.assert_array_equal(first["tokens"], p1.batch_at(0)["tokens"])
    with pytest.raises(ValueError, match="split"):
        TokenPipeline(cfg, n_shards=3)


# ---------------------------------------------------------------- xent
XENT = {"chunked": (64, 16, True), "one_chunk": (48, 32, True),
        "untied": (64, 16, False), "whole": (32, 64, True)}


@pytest.fixture(scope="module")
def jax_xent():
    """{case: (x, labels, embed params, JAX chunked_xent value, its grads
    for (embed, x), JAX softmax_xent of the full logits)}."""
    out = {}
    rng = np.random.default_rng(0)
    for case, (seq, chunk, tied) in XENT.items():
        cfg = dataclasses.replace(JAX_TINY, loss_chunk=chunk,
                                  tie_embeddings=tied, vocab=97, d_model=24)
        x = rng.normal(0, 1, (3, seq, 24)).astype(np.float32)
        labels = rng.integers(0, 97, (3, seq)).astype(np.int32)
        emb = {"tok": rng.normal(0, 0.3, (97, 24)).astype(np.float32)}
        if not tied:
            emb["lm_head"] = rng.normal(0, 0.3, (24, 97)).astype(np.float32)
        fn = functools.partial(jax_layers.chunked_xent, cfg)
        val, grads = jax.value_and_grad(fn, argnums=(0, 1))(emb, x, labels)
        full = jax_layers.softmax_xent(
            jax_layers.lm_logits(cfg, emb, x), labels)
        out[case] = (x, labels, emb, float(val),
                     jax.tree.map(np.asarray, grads), float(full))
    return out


@pytest.mark.parametrize("case", sorted(XENT))
def test_chunked_xent_matches_jax_and_the_full_softmax(jax_xent, case):
    x, labels, emb, want, (g_emb, g_x), full = jax_xent[case]
    seq, chunk, tied = XENT[case]
    cfg = dataclasses.replace(TINY, loss_chunk=chunk, tie_embeddings=tied,
                              vocab=97, d_model=24)
    pe = {k: torch.tensor(v, requires_grad=True) for k, v in emb.items()}
    px = torch.tensor(x, requires_grad=True)
    got = layers.chunked_xent(cfg, pe, px, torch.tensor(labels))
    assert got.dtype == torch.float32 and got.shape == ()
    assert float(got.detach()) == pytest.approx(want, rel=LOSS_RTOL)
    got.backward()
    for k in emb:
        # an untied table does not reach the loss: JAX's grad is zeros
        g = pe[k].grad
        np.testing.assert_allclose(
            np.zeros_like(g_emb[k]) if g is None else g.numpy(), g_emb[k],
            rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(px.grad.numpy(), g_x, rtol=1e-4, atol=1e-7)
    with torch.no_grad():
        plain = layers.softmax_xent(layers.lm_logits(cfg, pe, px),
                                    torch.tensor(labels))
    assert float(plain) == pytest.approx(full, rel=LOSS_RTOL)
    assert float(plain) == pytest.approx(float(got.detach()),
                                         rel=LOSS_RTOL)


# ------------------------------------------------- loss_fn per family
@pytest.fixture(scope="module")
def jax_losses():
    """{case: (JAX params as numpy, batch, JAX loss, JAX grads as numpy)}:
    ``jax.value_and_grad`` of the reference's loss_fn, jitted."""
    out = {}
    for name in CASES:
        jcfg, _ = _cfgs(name)
        jp = jax_registry.init_params(jcfg, jax.random.PRNGKey(0))
        batch = _batch(jcfg)
        val, grads = jax.jit(jax.value_and_grad(
            functools.partial(jax_registry.loss_fn, jcfg)))(jp, batch)
        out[name] = (jax.tree.map(np.asarray, jp), batch, float(val),
                     jax.tree.map(np.asarray, grads))
    return out


def _hold_grads(got, want):
    """Every leaf within GRAD_REL * max|want leaf| + GRAD_ABS; returns the
    worst ratio of |difference| to that tolerance."""
    g, w = dict(T.items(got)), dict(T.items(want))
    assert g.keys() == w.keys()
    worst = 0.0
    for k in w:
        tol = GRAD_REL * float(np.abs(w[k]).max()) + GRAD_ABS
        d = float(np.abs(g[k].numpy() - w[k]).max())
        assert d <= tol, (k, d, tol)
        worst = max(worst, d / tol)
    return worst


@pytest.mark.parametrize("name", CASES)
def test_loss_and_grads_match_jax(jax_losses, name):
    jp, batch, want, want_g = jax_losses[name]
    _, pcfg = _cfgs(name)
    params = convert.lm_params_from_numpy(pcfg, jp, device="cpu")
    loss, grads = value_and_grad(functools.partial(registry.loss_fn, pcfg))(
        params, _port_batch(batch))
    assert loss.dtype == torch.float32 and not loss.requires_grad
    assert float(loss) == pytest.approx(want, rel=LOSS_RTOL)
    _hold_grads(grads, want_g)
    assert all(not x.requires_grad for x in T.leaves(params))


def test_loss_fn_runs_under_no_grad_and_equals_the_forward():
    """Under no_grad the loss is the plain forward's cross entropy (remat
    and the chunk checkpoints step aside), as in serving."""
    cfg = smoke_config("gemma-7b")
    params = registry.init_params(cfg, torch.Generator().manual_seed(0))
    jcfg, _ = _cfgs("gemma-7b")
    batch = _port_batch(_batch(jcfg))
    from repro_torch.models import dense

    with torch.no_grad():
        loss = registry.loss_fn(cfg, params, batch)
        full = layers.softmax_xent(dense.forward(cfg, params,
                                                 batch["tokens"]),
                                   batch["labels"])
    assert float(loss) == pytest.approx(float(full), rel=LOSS_RTOL)


def test_moe_loss_carries_the_aux_term():
    cfg = smoke_config("deepseek-moe-16b")
    params = registry.init_params(cfg, torch.Generator().manual_seed(0))
    batch = _port_batch(_batch(_cfgs("deepseek-moe-16b")[0]))
    from repro_torch.models import moe

    with torch.no_grad():
        x, aux = moe.hidden_states(cfg, params, batch["tokens"])
        xent = layers.chunked_xent(cfg, params["embed"], x, batch["labels"])
        loss = registry.loss_fn(cfg, params, batch)
    assert float(aux) > 0
    assert float(loss) == pytest.approx(float(xent + 0.01 * aux), rel=1e-6)


# ---------------------------------------------------------------- remat
@pytest.mark.parametrize("name", ["tiny", "deepseek-moe-16b", "mamba2-130m",
                                  "zamba2-1.2b"])
def test_grads_equal_across_remat_policies(name):
    grads = {}
    for remat in ("none", "full", "dots"):
        _, cfg = _cfgs(name, remat=remat)
        params = registry.init_params(cfg, torch.Generator().manual_seed(1))
        batch = _port_batch(_batch(_cfgs(name)[0], seed=2))
        loss, g = value_and_grad(functools.partial(registry.loss_fn, cfg))(
            params, batch)
        grads[remat] = (loss, g)
    for remat in ("full", "dots"):
        assert torch.equal(grads[remat][0], grads["none"][0])
        for a, b in zip(T.leaves(grads[remat][1]), T.leaves(grads["none"][1])):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_remat_rejects_an_unknown_policy():
    with pytest.raises(ValueError, match="remat"):
        layers.remat("some", lambda x: x)


def test_layer_params_splits_every_stacked_leaf():
    cfg = smoke_config("mamba2-130m")
    params = registry.init_params(cfg, torch.Generator().manual_seed(0))
    per = layers.layer_params(params["blocks"], cfg.n_layers)
    assert len(per) == cfg.n_layers
    for i, lp in enumerate(per):
        for (k, a), (_, b) in zip(T.items(lp),
                                  T.items(layers.index_layer(
                                      params["blocks"], i))):
            assert torch.equal(a, b), k
    with pytest.raises(ValueError, match="layers"):
        layers.layer_params(params["blocks"], cfg.n_layers + 1)
