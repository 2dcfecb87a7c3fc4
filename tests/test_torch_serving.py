"""The port's serving slice against ``repro``'s: ``serve_batch``,
``ServeEngine`` and the ``launch.serve`` CLI, on the CPU.

Both packages run the same weights (``params_from_reference``) on the
same numpy prompts.  Greedy tokens must be equal; logits (float32
reduced configs) agree to 1e-4.  With flash attention on, the reference
runs its Pallas kernel in interpret mode and the port K8's plain version.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.launch.serve import serve_batch as ref_serve_batch
from repro.models import lm as ref_lm
from repro.serving import ServeEngine as RefServeEngine
from repro_torch import configs
from repro_torch.kernels import flash_attention as k8
from repro_torch.launch import serve
from repro_torch.models import lm
from repro_torch.models.weights import params_from_reference
from repro_torch.serving import ServeEngine

DENSE = ["olmo-1b", "h2o-danube-1.8b", "phi3-medium-14b", "gemma-7b"]


def _both(arch, seed=0, **overrides):
    rcfg = ref_configs.get_reduced(arch).with_(**overrides)
    params, _ = ref_lm.init(rcfg, jax.random.PRNGKey(seed))
    cfg = configs.get_reduced(arch).with_(**overrides)
    model = params_from_reference(cfg, jax.tree.map(np.asarray, params),
                                  device="cpu")
    return rcfg, params, cfg, model


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("flash", [False, True])
def test_serve_batch_matches_reference(arch, flash):
    rcfg, params, cfg, model = _both(arch, use_flash_attention=flash)
    # 11 prompt tokens + 6 new: past h2o-danube's reduced window of 8.
    prompts = np.random.RandomState(1).randint(
        2, cfg.vocab_size, size=(2, 11)).astype(np.int32)
    want, _ = ref_serve_batch(rcfg, params, prompts, 6)
    got, stats = serve.serve_batch(cfg, model, prompts, 6)
    assert got.dtype == np.int32 and got.shape == (2, 6)
    assert np.array_equal(got, np.asarray(want))
    assert stats["prefill_s"] > 0 and stats["decode_s"] > 0
    assert stats["tok_per_s"] > 0
    rcache, _ = ref_lm.make_cache(rcfg, 2, 17)
    _, rlogits = ref_lm.prefill(rcfg, params, jnp.asarray(prompts), rcache)
    _, logits = lm.prefill(cfg, model, torch.from_numpy(prompts),
                           lm.make_cache(cfg, 2, 17, device="cpu"))
    np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits), atol=1e-4)


def test_flash_path_goes_through_k8_wrapper(monkeypatch):
    _, _, cfg, model = _both("h2o-danube-1.8b", use_flash_attention=True)
    calls = []
    real = k8.flash_attention_plain
    monkeypatch.setattr(k8, "flash_attention_plain",
                        lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    serve.serve_batch(cfg, model, np.full((1, 5), 3, np.int32), 2)
    # One call per layer of the prefill, with the model's window.
    assert calls == [{"causal": True, "window": 8, "scale": None}] * 2


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "phi3-medium-14b"])
def test_serve_engine_matches_reference(arch):
    """3 requests of different lengths over 2 slots: slots are reused with
    stale cache rows, and the ring (h2o-danube, window 8) wraps."""
    rcfg, params, cfg, model = _both(arch, seed=1)
    rng = np.random.RandomState(2)
    reqs = [(rng.randint(2, cfg.vocab_size, size=n).astype(np.int32), m)
            for n, m in ((5, 4), (14, 6), (3, 5))]
    ref = RefServeEngine(rcfg, params, slots=2, cache_len=24, eos_id=-1)
    eng = ServeEngine(cfg, model, slots=2, cache_len=24, eos_id=-1)
    for prompt, max_tokens in reqs:
        ref.submit(prompt, max_tokens=max_tokens)
        eng.submit(prompt, max_tokens=max_tokens)
    want = ref.run_until_drained()
    got = eng.run_until_drained()
    assert [r.rid for r in got] == [r.rid for r in want]
    assert [r.out for r in got] == [r.out for r in want]
    assert [len(r.out) for r in got] == [4, 6, 5]
    for f in ("steps", "tokens_out", "prefills", "batch_occupancy_sum"):
        assert getattr(eng.stats, f) == getattr(ref.stats, f), f
    # A prompt longer than the cache allows is cut as the reference cuts it.
    long_prompt = rng.randint(2, cfg.vocab_size, size=40).astype(np.int32)
    ref.submit(long_prompt, max_tokens=3)
    eng.submit(long_prompt, max_tokens=3)
    assert [r.out for r in eng.run_until_drained()] == \
        [r.out for r in ref.run_until_drained()]


def test_serve_engine_matches_offline_decode():
    """Engine output == serve_batch's greedy decode for one request."""
    _, _, cfg, model = _both("phi3-medium-14b", seed=1)
    prompt = np.random.RandomState(1).randint(2, cfg.vocab_size,
                                              size=8).astype(np.int32)
    toks, _ = serve.serve_batch(cfg, model, prompt[None], max_new=5,
                                cache_len=32)
    eng = ServeEngine(cfg, model, slots=2, cache_len=32, eos_id=-1)
    eng.submit(prompt, max_tokens=5)
    (req,) = eng.run_until_drained()
    assert req.out == toks[0].tolist()


def test_main_on_cpu(capsys):
    serve.main(["--arch", "h2o-danube-1.8b", "--batch", "2",
                "--prompt-len", "6", "--tokens", "3", "--device", "cpu"])
    assert "decoded (2, 3) tokens" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="encoder-decoder"):
        serve.main(["--arch", "whisper-medium", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="VLM"):
        serve.main(["--arch", "internvl2-2b", "--device", "cpu"])


def test_main_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "olmo-1b"])
