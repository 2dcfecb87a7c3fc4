"""The port's model stack (dense family) against ``repro.models``.

Weights come from the reference's ``lm.init`` through
``params_from_reference``; inputs are made with numpy from a seed.  The
reduced configs are float32.  ``pos`` maps are held bit for bit, logits
to 1e-4 (as the serving tests), and k/v caches to 1e-5 times the
buffer's largest magnitude (at least 1): the first layer's k and v
(magnitudes near 20) agree to about 4e-6, but the second layer's
inherit the first layer's float32 rounding through the residual stream
and softmax and differ by up to about 3e-5 (about 13 ulp at that
magnitude) between the two packages' matrix products.
"""
import ast
import dataclasses
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import layers as ref_layers
from repro.models import lm as ref_lm
from repro_torch import configs
from repro_torch.models import layers, lm
from repro_torch.models.config import ModelConfig
from repro_torch.models.weights import params_from_reference, reference_name

DENSE = ["olmo-1b", "h2o-danube-1.8b", "phi3-medium-14b", "gemma-7b"]
PORT_SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch"


def _ref_params(arch, seed=0):
    cfg = ref_configs.get_reduced(arch)
    params, _ = ref_lm.init(cfg, jax.random.PRNGKey(seed))
    return cfg, params


def _flat(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        out.update(_flat(val, path) if isinstance(val, dict) else {path: val})
    return out


def _port_as_reference(model, n_layers):
    """The port's parameters under the reference's stacked names."""
    out = {}
    for name, p in model.named_parameters():
        ref, layer = reference_name(name)
        shape = tuple(p.shape) if layer is None else (n_layers, *p.shape)
        assert out.setdefault(ref, (shape, p.dtype)) == (shape, p.dtype), name
    return out


# -- configs --------------------------------------------------------------------

def test_configs_match_reference():
    assert configs.ARCH_IDS == ref_configs.ARCH_IDS
    for arch in configs.ARCH_IDS:
        for get, ref_get in ((configs.get_config, ref_configs.get_config),
                             (configs.get_reduced, ref_configs.get_reduced)):
            assert (dataclasses.asdict(get(arch))
                    == dataclasses.asdict(ref_get(arch))), arch
    ref_fields = [(f.name, f.default) for f in
                  dataclasses.fields(ref_configs.get_config("olmo-1b"))]
    assert [(f.name, f.default) for f in dataclasses.fields(ModelConfig)] \
        == ref_fields
    cfg = configs.get_config("h2o-danube-1.8b")
    assert (cfg.pdtype, cfg.cdtype) == (torch.bfloat16, torch.bfloat16)
    assert configs.get_reduced("olmo-1b").pdtype == torch.float32
    assert configs.paper_dedup_config().num_bands == 50
    assert configs.paper_dist_lsh_config().num_hashes == 100


# -- init -----------------------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE)
def test_init_names_shapes_dtypes_match_reference(arch):
    for cfg_fn, ref_fn in ((configs.get_config, ref_configs.get_config),
                           (configs.get_reduced, ref_configs.get_reduced)):
        cfg, rcfg = cfg_fn(arch), ref_fn(arch)
        full = cfg_fn is configs.get_config
        # Full width: shapes only (the meta device; abstract in the
        # reference).  Reduced: real tensors.
        model = (lm.init(cfg, device="meta") if full else
                 lm.init(cfg, torch.Generator().manual_seed(0), device="cpu"))
        ref, _ = ref_lm.init(rcfg, jax.random.PRNGKey(0), abstract=full)
        got = _port_as_reference(model, cfg.n_layers)
        want = {k: (tuple(v.shape), str(v.dtype)) for k, v in _flat(ref).items()}
        assert {k: (s, str(d).removeprefix("torch."))
                for k, (s, d) in got.items()} == want


@pytest.mark.parametrize("arch", DENSE)
def test_init_follows_reference_init_rules(arch):
    cfg = configs.get_reduced(arch).with_(d_model=128, d_ff=256)
    model = lm.init(cfg, torch.Generator().manual_seed(1), device="cpu")
    ref, _ = ref_lm.init(ref_configs.get_reduced(arch).with_(
        d_model=128, d_ff=256), jax.random.PRNGKey(1))
    ref = _flat(ref)
    for name, p in model.named_parameters():
        ref_name, layer = reference_name(name)
        want = np.asarray(ref[ref_name] if layer is None
                          else ref[ref_name][layer])
        if name.endswith("scale") and cfg.norm == "rmsnorm":
            assert not p.any() and not want.any(), name   # starts at zero
            continue
        shape = tuple(p.shape)
        fan_in = cfg.d_model if name == "embed" else shape[-2]
        std = 1 / math.sqrt(fan_in)
        # Tensors of >= 2,048 values: the sample std is within 10 %.
        assert abs(float(p.std()) / std - 1) < 0.1, name
        assert abs(float(want.std()) / std - 1) < 0.1, name
        assert abs(float(p.mean())) < 0.1 * std, name


def test_other_families_raise_not_implemented():
    for arch in configs.ARCH_IDS:
        cfg = configs.get_reduced(arch)
        assert lm.unit_layout(cfg) == ref_lm.unit_layout(
            ref_configs.get_reduced(arch))
        if arch in DENSE:
            continue
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            lm.init(cfg, torch.Generator(), device="cpu")
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            lm.make_cache(cfg, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="generator"):
        lm.init(configs.get_reduced("olmo-1b"), device="cpu")


def test_params_from_reference_refuses_a_mismatch():
    _, params = _ref_params("phi3-medium-14b")
    cfg = configs.get_reduced("phi3-medium-14b")
    tree = jax.tree.map(np.asarray, params)
    with pytest.raises(ValueError, match="shape"):
        params_from_reference(cfg.with_(d_ff=64), tree, device="cpu")
    tree["extra"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="extra"):
        params_from_reference(cfg, tree, device="cpu")


# -- layers ---------------------------------------------------------------------

def test_norms_rope_and_glu_match_reference():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 5, 4, 16).astype(np.float32)
    w = rng.randn(16).astype(np.float32)
    pos = np.arange(5, dtype=np.int32)[None] + 3
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    pairs = [
        (layers.rmsnorm(tx, tw), ref_layers.rmsnorm(x, w)),
        (layers.layernorm(tx, tw, tw), ref_layers.layernorm(x, w, w)),
        (layers.apply_norm("nonparam_ln", tx, None),
         ref_layers.apply_norm("nonparam_ln", x, None)),
        (layers.apply_rope(tx, torch.from_numpy(pos), 500.0),
         ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 500.0)),
        (layers.glu_act("swiglu", tx, tx.flip(-1)),
         ref_layers.glu_act("swiglu", x, x[..., ::-1])),
        (layers.glu_act("geglu", tx, tx.flip(-1)),
         ref_layers.glu_act("geglu", x, x[..., ::-1])),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


# -- caches, prefill, decode ----------------------------------------------------

def _prefill_both(arch, prompt_len, cache_len, B=2, seed=3):
    rcfg, params = _ref_params(arch)
    cfg = configs.get_reduced(arch)
    model = params_from_reference(cfg, jax.tree.map(np.asarray, params),
                                  device="cpu")
    tokens = np.random.RandomState(seed).randint(
        2, cfg.vocab_size, size=(B, prompt_len)).astype(np.int32)
    rcache, _ = ref_lm.make_cache(rcfg, B, cache_len)
    rcache, rlogits = ref_lm.prefill(rcfg, params, jnp.asarray(tokens), rcache)
    cache = lm.make_cache(cfg, B, cache_len, device="cpu")
    cache, logits = lm.prefill(cfg, model, torch.from_numpy(tokens), cache)
    return (cfg, rcfg, params, model), (rcache, rlogits), (cache, logits)


def _assert_cache_equal(cache, rcache):
    assert set(cache) == set(rcache)
    for name, want in rcache.items():
        want = np.asarray(want)
        got = cache[name].numpy()
        assert got.shape == want.shape and got.dtype == want.dtype, name
        if name == "pos":
            assert np.array_equal(got, want)
        else:
            scale = max(1.0, float(np.abs(want).max()))
            assert np.abs(got - want).max() <= 1e-5 * scale, name


# h2o-danube's reduced window is 8: prompts shorter than, equal to and
# longer than the ring; phi3 has no window (a linear cache).
@pytest.mark.parametrize("arch,prompt_len,cache_len", [
    ("h2o-danube-1.8b", 5, 16),
    ("h2o-danube-1.8b", 8, 16),
    ("h2o-danube-1.8b", 13, 16),
    ("h2o-danube-1.8b", 13, 6),
    ("phi3-medium-14b", 7, 16),
    ("phi3-medium-14b", 16, 16),
])
def test_prefill_cache_and_decode_match_reference(arch, prompt_len, cache_len):
    (cfg, rcfg, params, model), (rcache, rlogits), (cache, logits) = \
        _prefill_both(arch, prompt_len, cache_len)
    np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits), atol=1e-4)
    assert logits.shape == (2, 1, cfg.vocab_size)
    _assert_cache_equal(cache, rcache)
    # Two decode steps from the prefilled caches, at per-row lengths.
    tok = np.array([3, 7], np.int32)
    for step in range(2):
        kv_len = np.array([prompt_len + step, prompt_len - 1 + step], np.int32)
        rlogits, rcache = ref_lm.decode(rcfg, params, rcache, jnp.asarray(tok),
                                        jnp.asarray(kv_len))
        logits, cache = lm.decode(cfg, model, cache, torch.from_numpy(tok),
                                  torch.from_numpy(kv_len))
        np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits),
                                   atol=1e-4)
        _assert_cache_equal(cache, rcache)
        tok = np.asarray(jnp.argmax(rlogits[:, 0], axis=-1)).astype(np.int32)


def test_make_cache_matches_reference():
    for arch, seq in (("h2o-danube-1.8b", 20), ("h2o-danube-1.8b", 4),
                      ("gemma-7b", 12)):
        rcache, _ = ref_lm.make_cache(ref_configs.get_reduced(arch), 3, seq)
        _assert_cache_equal(
            lm.make_cache(configs.get_reduced(arch), 3, seq, device="cpu"),
            rcache)


def test_entry_points_without_a_card_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, params = _ref_params("olmo-1b")
    cfg = configs.get_reduced("olmo-1b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.make_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_reference(cfg, jax.tree.map(np.asarray, params))


def test_port_imports_neither_jax_nor_repro():
    for path in sorted(PORT_SRC.rglob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), (path, name)
