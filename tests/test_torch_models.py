"""The port's models against the JAX package, and their own properties.

Parameters are drawn by the JAX package and carried across with
``carry.params_from_reference``, so both packages compute the same
function on the same seeded numpy tokens.  Tolerance for logits: 1e-3
absolute, f32 smoke configs (the reference's own decode-vs-forward
tolerance; sin/cos of RoPE angles and the softmax exp round slightly
differently in the two frameworks, about 2e-4 measured).
"""
from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import model as JM
from repro.models.common import cross_entropy as j_cross_entropy
from repro.models.decoder import init_cache as j_init_cache
from repro_torch.carry import params_from_reference
from repro_torch.configs import get_config, list_configs
from repro_torch.models import model as TM
from repro_torch.models.common import cross_entropy
from repro_torch.models.decoder import init_cache
from torch_parity import one_torch_thread  # noqa: F401

ATOL = 1e-3
ARCHS = ("granite-8b-smoke", "gemma3-1b-smoke")
CPU = "cpu"
pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _pair(name, **over):
    jcfg = replace(j_get_config(name), **over)
    tcfg = replace(get_config(name), **over)
    jp = JM.init_params(jcfg, 0)
    tp = params_from_reference(jax.tree.map(np.asarray, jp), tcfg, CPU)
    return jcfg, tcfg, jp, tp


def _tokens(cfg, b, t, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_the_reference(arch, impl):
    jcfg, tcfg, jp, tp = _pair(arch)
    tcfg = replace(tcfg, attn_impl=impl)
    toks = _tokens(tcfg, 2, 80)
    want = np.asarray(JM.forward(jp, toks, jcfg))
    got = TM.forward(tp, torch.from_numpy(toks).long(), tcfg)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_logits_match_the_reference(arch):
    """80 decode steps: past gemma3-smoke's 64-token rolling window."""
    jcfg, tcfg, jp, tp = _pair(arch)
    toks = _tokens(tcfg, 2, 80, seed=1)
    step = jax.jit(JM.decode_step, static_argnames="cfg")
    jc, tc = j_init_cache(jcfg, 2, 96), init_cache(tcfg, 2, 96, device=CPU)
    if arch.startswith("gemma3"):
        assert tc["scan"][0]["0"]["k"].shape[2] == tcfg.window == 64
    worst = 0.0
    for i in range(toks.shape[1]):
        a, jc = step(jp, jc, toks[:, i:i + 1], i, cfg=jcfg)
        b, tc = TM.decode_step(tp, tc, torch.from_numpy(toks[:, i:i + 1])
                               .long(), i, tcfg)
        worst = max(worst, float(np.abs(np.asarray(a) - b.numpy()).max()))
    assert worst < ATOL


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """KV caches (rolling windows included) reproduce teacher-forced
    logits, as ``tests/test_models_smoke.py`` holds the reference."""
    cfg = replace(get_config(arch), n_prefix_tokens=0)
    params = TM.init_params(cfg, 0, CPU)
    toks = torch.from_numpy(_tokens(cfg, 2, 80, seed=2)).long()
    full = TM.forward(params, toks, cfg)
    cache = init_cache(cfg, 2, 80, device=CPU)
    worst = 0.0
    for t in range(toks.shape[1]):
        lg, cache = TM.decode_step(params, cache, toks[:, t:t + 1], t, cfg)
        worst = max(worst, float((lg - full[:, t]).abs().max()))
    assert worst < ATOL


def test_prefix_embeds_and_loss_match_the_reference():
    jcfg, tcfg, jp, tp = _pair("granite-8b-smoke")
    rng = np.random.default_rng(3)
    toks = _tokens(tcfg, 2, 20, seed=3)
    emb = rng.standard_normal((2, 4, tcfg.d_model)).astype(np.float32)
    labels = _tokens(tcfg, 2, 24, seed=4)
    mask = (rng.random((2, 24)) > 0.2).astype(np.float32)
    want = float(JM.loss_fn(jp, {"tokens": toks, "labels": labels,
                                 "mask": mask, "prefix_embeds": emb}, jcfg))
    got = float(TM.loss_fn(tp, {
        "tokens": torch.from_numpy(toks).long(),
        "labels": torch.from_numpy(labels).long(),
        "mask": torch.from_numpy(mask),
        "prefix_embeds": torch.from_numpy(emb)}, tcfg))
    assert abs(got - want) < ATOL
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32)
    lab = rng.integers(0, 11, (2, 5))
    np.testing.assert_allclose(
        float(cross_entropy(torch.from_numpy(logits),
                            torch.from_numpy(lab))),
        float(j_cross_entropy(logits, lab)), atol=1e-6)


def test_parameters_are_stored_in_the_config_dtype():
    """bf16 configs keep matrices and embeddings in bf16 (rounded once)
    and RMSNorm weights in f32; the same seed gives the same draws."""
    cfg = replace(get_config("granite-8b-smoke"), dtype="bfloat16")
    p = TM.init_params(cfg, 7, CPU)
    sd = p.state_dict()
    assert sd["embed"].dtype == torch.bfloat16
    assert sd["layers.scan.0.0.mix.wq"].dtype == torch.bfloat16
    assert sd["layers.scan.0.0.norm1"].dtype == torch.float32
    assert sd["final_norm"].dtype == torch.float32
    again = TM.init_params(cfg, 7, CPU).state_dict()
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    other = TM.init_params(cfg, 8, CPU).state_dict()
    assert not torch.equal(sd["embed"], other["embed"])
    # a lecun draw has std 1/sqrt(fan_in)
    std = float(sd["layers.scan.0.0.ffn.w2"].float().std())
    assert abs(std * cfg.d_ff ** 0.5 - 1.0) < 0.05


def test_carried_bf16_parameters_round_once():
    jcfg = replace(j_get_config("granite-8b-smoke"), dtype="bfloat16")
    tcfg = replace(get_config("granite-8b-smoke"), dtype="bfloat16")
    jp = jax.tree.map(np.asarray, JM.init_params(jcfg, 0))
    tp = params_from_reference(jp, tcfg, CPU).state_dict()
    wq = jp["layers"]["scan"]["0"]["mix"]["wq"][1]
    assert torch.equal(tp["layers.scan.1.0.mix.wq"],
                       torch.from_numpy(np.array(wq)).bfloat16())
    assert tp["layers.scan.1.0.norm1"].dtype == torch.float32


def test_carry_rejects_a_tree_of_another_config():
    jp = jax.tree.map(np.asarray, JM.init_params(
        j_get_config("granite-8b-smoke"), 0))
    with pytest.raises(ValueError, match="shape"):
        params_from_reference(jp, replace(get_config("granite-8b-smoke"),
                                          d_ff=128), CPU)
    with pytest.raises(ValueError, match="missing"):
        params_from_reference(jp, get_config("gemma3-1b-smoke"), CPU)


def test_configs_are_the_reference_configs():
    from repro.configs import list_configs as j_list

    assert list_configs() == j_list()
    for name in list_configs():
        for n in (name, name + "-smoke"):
            j, t = j_get_config(n), get_config(n)
            assert vars(j) == vars(t), n
            assert j.param_count() == t.param_count()
            assert j.layer_kinds() == t.layer_kinds()


def test_granite_spec_count_is_its_parameter_count():
    """The full-width config's specs (never materialized here) hold
    param_count() weights plus the norms."""
    from repro_torch.models.common import map_specs

    cfg = get_config("granite-8b")
    sizes = []
    map_specs(TM.model_specs(cfg),
              lambda s: sizes.append(int(np.prod(s.shape))))
    norms = (2 * cfg.n_layers + 1) * cfg.d_model
    assert sum(sizes) == cfg.param_count()[0] + norms
