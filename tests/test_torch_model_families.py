"""The port's Mamba, RG-LRU, MoE and MLA families against the JAX package.

Four ``-smoke`` configs cover the block kinds and the FFN kind that the
dense-GQA slice left out: falcon-mamba-7b (mamba), recurrentgemma-9b
(rglru + local), llama4-scout-17b-a16e (attn + MoE with a shared
expert) and deepseek-v2-236b (MLA, a dense first layer, then MoE).
Parameters are drawn by the JAX package and carried across with
``carry.params_from_reference``; both packages run the same seeded
numpy tokens.

Tolerances:
  * logits (forward, 80 decode steps, decode against forward): 1e-3
    absolute, f32 (the reference's own decode-vs-forward tolerance;
    about 2e-4 to 8e-4 measured: the reference's stacked-scan lecun
    draws take their fan-in from the repeat axis, so hidden states grow
    to about 1e3 and f32 rounding grows with them);
  * MoE routing (top indices, ``keep``, slots): exact, at capacity
    factors 0.5 (drops), 1.25 (the configs') and dropless;
  * one MoE FFN call: within 1e-6 of its largest output, f32;
  * the MoE combine under a permutation of the dispatch order: bitwise.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import common as j_common
from repro.models import ffn as JF
from repro.models import model as JM
from repro.models.decoder import init_cache as j_init_cache
from repro_torch.carry import params_from_reference
from repro_torch.configs import get_config, list_configs
from repro_torch.models import ffn as TF
from repro_torch.models import model as TM
from repro_torch.models.common import map_specs
from repro_torch.models.decoder import init_cache, map_cache
from torch_parity import one_torch_thread  # noqa: F401

ATOL = 1e-3
FAMILIES = ("falcon-mamba-7b-smoke", "recurrentgemma-9b-smoke",
            "llama4-scout-17b-a16e-smoke", "deepseek-v2-236b-smoke")
MOE = ("llama4-scout-17b-a16e-smoke", "deepseek-v2-236b-smoke")
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
@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_logits_match_the_reference(arch, impl):
    """``pallas`` runs the JAX package's Pallas flash kernel in interpret
    mode (its blocks need T = 128) and the port's kernel wrapper (its
    plain version on CPU tensors); Mamba and MLA reach no kernel."""
    jcfg, tcfg, jp, tp = _pair(arch, attn_impl=impl)
    toks = _tokens(tcfg, 2, 128 if impl == "pallas" else 80)
    want = np.asarray(JM.forward(jp, toks, jcfg))
    got = TM.forward(tp, torch.from_numpy(toks).long(), tcfg)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_logits_match_the_reference(arch):
    """80 decode steps: past recurrentgemma-smoke's 64-token window."""
    jcfg, tcfg, jp, tp = _pair(arch)
    toks = _tokens(tcfg, 2, 80, seed=1)
    step = jax.jit(JM.decode_step, static_argnames="cfg")
    jc, tc = j_init_cache(jcfg, 2, 96), init_cache(tcfg, 2, 96, device=CPU)
    worst = 0.0
    for i in range(toks.shape[1]):
        a, jc = step(jp, jc, toks[:, i:i + 1], i, cfg=jcfg)
        b, tc = TM.decode_step(tp, tc, torch.from_numpy(toks[:, i:i + 1])
                               .long(), i, tcfg)
        worst = max(worst, float(np.abs(np.asarray(a) - b.numpy()).max()))
    assert worst < ATOL


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_matches_forward(arch):
    """Recurrent states, latent caches and rolling windows reproduce the
    teacher-forced logits, as ``tests/test_models_smoke.py`` holds the
    reference (MoE dropless there too: a token's route must not depend
    on the other tokens of its batch)."""
    cfg = replace(get_config(arch), n_prefix_tokens=0)
    if cfg.n_experts:
        cfg = replace(cfg, capacity_factor=float(cfg.n_experts))
    params = TM.init_params(cfg, 0, CPU)
    toks = torch.from_numpy(_tokens(cfg, 2, 80, seed=2)).long()
    full = TM.forward(params, toks, cfg)
    cache = init_cache(cfg, 2, 80, device=CPU)
    worst = 0.0
    for t in range(toks.shape[1]):
        lg, cache = TM.decode_step(params, cache, toks[:, t:t + 1], t, cfg)
        worst = max(worst, float((lg - full[:, t]).abs().max()))
    assert worst < ATOL


def _moe_layer(arch, capacity_factor):
    jcfg, tcfg, jp, tp = _pair(arch, capacity_factor=capacity_factor)
    jl = jax.tree.map(lambda a: np.asarray(a)[0], jp["layers"]["scan"])
    return jcfg, tcfg, jl["0"]["ffn"], tp["layers"]["scan"][0]["0"]["ffn"]


@pytest.mark.parametrize("cf", [0.5, 1.25, None], ids=["cf0.5", "cf1.25",
                                                         "dropless"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_routing_equals_the_reference(arch, cf, monkeypatch):
    """Top indices, kept entries and slots, exactly.  The reference's
    own dispatch buffers are read where ``moe_forward`` hands them to
    ``constrain``: the sorted tokens times ``keep`` (``src``) and the
    expert slots (``expert_in``)."""
    n_exp = j_get_config(arch).n_experts
    jcfg, tcfg, jp, tp = _moe_layer(arch, float(n_exp) if cf is None
                                    else cf)
    seen = []
    monkeypatch.setattr(j_common, "constrain",
                        lambda x, dims: seen.append(np.array(x)) or x)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, tcfg.d_model)).astype(np.float32)
    want = np.asarray(JF.moe_forward(jp, jnp.asarray(x), jcfg, jnp.float32))
    j_src, j_expert_in = seen[1], seen[2]

    xf = torch.from_numpy(x.reshape(32, -1))
    r = TF.route(tcfg, xf @ tp["router"])
    gates = jax.nn.softmax((jnp.asarray(x.reshape(32, -1))
                            @ jp["router"]).astype(jnp.float32), axis=-1)
    _, j_top = jax.lax.top_k(gates, jcfg.top_k)
    np.testing.assert_array_equal(r.top_idx.numpy(), np.asarray(j_top))
    src = xf[r.sorted_tok] * r.keep[:, None].float()
    assert torch.equal(src, torch.from_numpy(j_src))
    buf = torch.zeros((n_exp * r.capacity + 1, tcfg.d_model))
    buf[r.slot] = src
    assert torch.equal(buf[:-1].reshape(n_exp, r.capacity, -1),
                       torch.from_numpy(j_expert_in))
    kept = int(r.keep.sum())
    if cf == 0.5:
        assert kept < 32 * tcfg.top_k        # the factor drops entries
    if cf is None:
        assert kept == 32 * tcfg.top_k

    got = TF.moe_forward(tp, torch.from_numpy(x), tcfg, torch.float32)
    assert float(np.abs(got.numpy() - want).max()) <= \
        1e-6 * float(np.abs(want).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 2, 6])
def test_moe_combine_does_not_depend_on_the_dispatch_order(k, dtype):
    """The same (token, choice) contributions, dispatched in two orders,
    sum to the same bits, in choice order."""
    s, d = 37, 24
    gen = torch.Generator().manual_seed(k)
    per_entry = torch.randn(s * k, d, generator=gen).to(dtype)
    outs = []
    for seed in (0, 1):
        order = torch.randperm(s * k, generator=torch.Generator()
                               .manual_seed(seed))
        outs.append(TF.combine(per_entry[order], order, s, k))
    assert torch.equal(outs[0], outs[1])
    by_choice = per_entry.reshape(s, k, d)
    want = by_choice[:, 0]
    for j in range(1, k):
        want = want + by_choice[:, j]
    assert outs[0].dtype == dtype and torch.equal(outs[0], want)


def _spec_sizes(specs) -> list:
    sizes = []
    map_specs(specs, lambda s: sizes.append(int(np.prod(s.shape))))
    return sizes


def _shapes(node, spec_type, path=""):
    """(path, shape) of every spec leaf; lists are indexed like dicts."""
    if isinstance(node, spec_type):
        return [(path, tuple(node.shape))]
    items = node.items() if isinstance(node, dict) else enumerate(node)
    return [x for k, v in items for x in _shapes(v, spec_type,
                                                 f"{path}.{k}")]


@pytest.mark.parametrize("arch", FAMILIES)
def test_specs_are_the_references_and_count_its_parameters(arch):
    """Leaf by leaf, the port's specs are the JAX package's (its stacked
    ``scan`` leaves split per repeat).  Their total is ``param_count()``
    plus what that count leaves out: the RMSNorm weights, Mamba's
    ``conv_b`` / ``dt_bias``, the MoE router, and MLA's projections
    (``param_count`` prices ``attn`` / ``local`` blocks only); and it
    counts an RG-LRU block with three w x w gate matrices where the block
    has two, and one of its two w vectors."""
    from repro.models.common import ParamSpec as JSpec
    from repro.models.model import model_specs as j_model_specs
    from repro_torch.models.attention import mla_specs
    from repro_torch.models.common import ParamSpec

    cfg = get_config(arch)
    tspecs = TM.model_specs(cfg)
    jspecs = j_model_specs(j_get_config(arch))
    want = [x for x in _shapes(jspecs, JSpec) if ".scan." not in x[0]]
    if "scan" in jspecs["layers"]:
        want += [(f".layers.scan.{r}{path}", shape[1:])
                 for path, shape in _shapes(jspecs["layers"]["scan"], JSpec)
                 for r in range(cfg.full_repeats)]
    assert sorted(_shapes(tspecs, ParamSpec)) == sorted(want)

    d = cfg.d_model
    left_out = d                                     # final_norm
    for li, kind in enumerate(cfg.layer_kinds()):
        left_out += d if kind == "mamba" else 2 * d  # norm1 (+ norm2)
        if kind == "mamba":
            left_out += 2 * cfg.d_inner
        elif kind == "rglru":
            w = cfg.lru_width_actual
            left_out += w - w * w
        elif kind == "mla":
            left_out += sum(_spec_sizes(mla_specs(cfg)))
        if cfg.ffn_kind_for_layer(li) == "moe":
            left_out += d * cfg.n_experts
    assert sum(_spec_sizes(tspecs)) == cfg.param_count()[0] + left_out


@pytest.mark.parametrize("name", list_configs())
def test_every_config_initialises_and_decodes(name):
    """All ten registered configs' smoke variants: parameters, a cache,
    one decode step and a short forward, finite."""
    cfg = replace(get_config(name + "-smoke"), n_prefix_tokens=0)
    params = TM.init_params(cfg, 0, CPU)
    cache = init_cache(cfg, 2, 16, device=CPU)
    logits, _ = TM.decode_step(params, cache, torch.zeros((2, 1),
                                                          dtype=torch.long),
                               0, cfg)
    assert logits.shape == (2, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    full = TM.forward(params, torch.zeros((1, 4), dtype=torch.long), cfg)
    assert full.shape == (1, 4, cfg.vocab_size)
    assert bool(torch.isfinite(full).all())


@pytest.mark.parametrize("arch", FAMILIES)
def test_bf16_models_keep_bf16_activations_and_caches(arch):
    """``A_log``, ``D`` and ``lam`` are stored in f32, as RMSNorm weights
    are; every use casts them as the reference does, so the logits and
    every cache leaf stay bf16 (an f32 promotion would make the logits
    f32, and ``copy_`` into a bf16 cache would hide it)."""
    cfg = replace(get_config(arch), dtype="bfloat16")
    params = TM.init_params(cfg, 0, CPU)
    sd = params.state_dict()
    for leaf in ("A_log", "D", "lam"):
        for key, val in sd.items():
            if key.endswith("." + leaf):
                assert val.dtype == torch.float32, key
    cache = init_cache(cfg, 1, 8, device=CPU)
    tok = torch.ones((1, 1), dtype=torch.long)
    for t in range(3):
        logits, cache = TM.decode_step(params, cache, tok, t, cfg)
        assert logits.dtype == torch.bfloat16
        assert bool(torch.isfinite(logits.float()).all())
    dtypes = set()
    map_cache(cache, lambda a: dtypes.add(a.dtype))
    assert dtypes == {torch.bfloat16}
    full = TM.forward(params, torch.ones((1, 3), dtype=torch.long), cfg)
    assert full.dtype == torch.bfloat16


def test_carry_splits_the_families_stacked_leaves():
    """Experts (R, E, d, f), ``A_log`` (R, di, st) and the MLA
    projections arrive per repeat, in their storage dtypes."""
    for arch, key, leaf in (
            ("llama4-scout-17b-a16e-smoke", "ffn", "w1"),
            ("falcon-mamba-7b-smoke", "mix", "A_log"),
            ("deepseek-v2-236b-smoke", "mix", "kv_down")):
        jcfg = replace(j_get_config(arch), dtype="bfloat16")
        tcfg = replace(get_config(arch), dtype="bfloat16")
        jp = jax.tree.map(np.asarray, JM.init_params(jcfg, 0))
        tp = params_from_reference(jp, tcfg, CPU)
        stacked = jp["layers"]["scan"]["0"][key][leaf]
        for r in range(tcfg.full_repeats):
            got = tp["layers"]["scan"][r]["0"][key][leaf]
            want = torch.from_numpy(np.array(stacked[r]))
            want = want if leaf == "A_log" else want.bfloat16()
            assert torch.equal(got, want), (arch, r)
