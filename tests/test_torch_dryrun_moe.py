"""The port's dry run on the MoE and MLA configurations
(``repro_torch.launch.dryrun``): llama4-scout routes its tokens through
``searchsorted`` on DTensors, deepseek-v2's MLA attends through the
plain attention on each rank's heads.  Each cell runs in a subprocess
of its own (the fake process group belongs to the process), as in
``tests/test_torch_dryrun.py``; a file of its own so that the cells
can run beside that file's."""
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
REFERENCE_OPS = {"all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                 "collective-permute"}


def _start_cell(arch: str, shape: str, multi_pod: bool = False):
    code = f"""
        import json
        from repro_torch.launch.dryrun import run_cell
        r = run_cell("{arch}", "{shape}", multi_pod={multi_pod}, save=False)
        print("RESULT_JSON:" + json.dumps(r, default=str))
    """
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(code)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)


def _finish_cell(proc, chips: int = 256) -> dict:
    stdout, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0, stderr[-3000:]
    line = [ln for ln in stdout.splitlines()
            if ln.startswith("RESULT_JSON:")][0]
    r = json.loads(line[len("RESULT_JSON:"):])
    assert r["status"] == "ok", (r.get("error"), r.get("traceback"))
    assert r["chips"] == chips
    assert r["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert set(r["collectives"]) <= REFERENCE_OPS
    assert r["collective_bytes_per_device"] == sum(r["collectives"].values())
    assert r["memory"]["peak_bytes_per_device_est"] > 0
    return r


def _port_cell(arch: str, shape: str) -> dict:
    return _finish_cell(_start_cell(arch, shape))


def test_llama4_scout_decode_cell():
    """One decode kernel a layer, and its flop formula's count of them:
    the 128 rows split 16 ways over ``data``; the 8 kv heads do not
    split over the 16 model ranks, so the two ranks that share each
    attend its 5 q heads over half its 32,768 slots apiece and merge
    the halves by their log-sum-exps; 4 D flops a slot.  The JAX
    package's partitioned HLO splits each kv head's 128-wide dim over
    the same two ranks instead (a dot of f32[8, 5, 32768] over 64): the
    same attention flops, and every other product is equal too, so the
    port's count is the JAX package's dot flops exactly."""
    from repro_torch.configs import get_config
    from test_torch_dryrun import _REFERENCE, _run

    cfg = get_config("llama4-scout-17b-a16e")
    r = _port_cell("llama4-scout-17b-a16e", "decode_32k")
    assert r["kernel_calls"] == {"decode_attention": cfg.n_layers}
    rows, slots = 128 // 16, 32768
    group = cfg.n_heads // cfg.n_kv_heads
    attention = cfg.n_layers * 4 * rows * group * (slots // 2) \
        * cfg.head_dim
    assert attention == 48 * 4 * 8 * 5 * 16384 * 128 == 16_106_127_360
    assert attention < r["flops_per_device"] < 3 * attention
    assert r["tokens_per_step"] == 128 and r["step_kind"] == "decode"

    ref = _run(_REFERENCE.replace('"granite-8b", "decode_32k"',
                                  '"llama4-scout-17b-a16e", "decode_32k"'))
    assert ref["status"] == "ok" and ref["chips"] == 256
    assert r["flops_per_device"] == ref["dot_flops"] == 34_508_963_840


def test_deepseek_v2_prefill_cell():
    """MLA attends through the plain attention on each rank's heads, as
    the JAX package's does: no kernel call; its products are counted on
    the rank's 2 rows and 8 of 128 heads, causal over 32,768 tokens.
    The MoE layers move entries by all-to-all, gather no "model" rank's
    share of the expert rows, keep the parent's flops within 1.01 and
    move at most half its collective bytes (the parent gathered the
    (160 x 49,153, 5,120) expert rows in each of the 59 MoE layers:
    6,016,437,288,960 B a device, 2.86 times the JAX package's
    2,107,272,177,920; the change's are 0.11 of the JAX package's)."""
    from repro_torch.configs import get_config
    from test_torch_dryrun_moe_split import check_split_moe

    cfg = get_config("deepseek-v2-236b")
    r = _port_cell("deepseek-v2-236b", "prefill_32k")
    check_split_moe(r, "deepseek-v2-236b", 847_622_931_087_360)
    assert r["collective_bytes_per_device"] <= 0.5 * 6_016_437_288_960
    assert r["collective_bytes_per_device"] < 2_107_272_177_920
    assert r["kernel_calls"] == {}
    t, heads, rows = 32768, cfg.n_heads // 16, 32 // 16
    d_qk = cfg.qk_nope_dim + cfg.qk_rope_dim
    # q k^T and p v over every (query, key) pair: the plain attention
    # multiplies the whole square and masks it; the projections and the
    # experts of the rank's 65,536 tokens add less than as much again
    attention = cfg.n_layers * 2 * rows * heads * t * t * (d_qk
                                                           + cfg.v_head_dim)
    assert attention < r["flops_per_device"] < 2 * attention
    assert r["tokens_per_step"] == 32 * 32768 and r["step_kind"] == "prefill"


def test_deepseek_v2_decode_cells():
    """Each "model" rank multiplies its share of a decode step's products
    by the ("embed", None) weights that FSDP splits over "data", MLA's
    latent down-projections (``q_down``, ``kv_down``) and the MoE router
    (``common.model_rows_product``; ROADMAP C16): the stream moves to a
    split of d over "data", each "model" rank takes 8 (``pod16x16``) / 4
    (``pod2x16x16``) of the group's rows, and the latents' partial sums
    are all-reduced over "data" and then to each rank's rows over
    "model".  The JAX package's partitioned HLO gives each rank the same
    products the other way round: its own rows over a sixteenth of d (a
    collective-permute of the weight's block), all-reduced over "model".
    So the port's flops a device are the JAX package's dot flops
    exactly; while each "model" rank repeated its "data" block's whole
    product they were 1.033 of them.  Collective bytes stay below the
    JAX package's totals."""
    from test_torch_dryrun import _REFERENCE, _run

    procs = [_start_cell("deepseek-v2-236b", "decode_32k", multi_pod=mp)
             for mp in (False, True)]
    refs = [_run(_REFERENCE.replace(
        'D.run_cell("granite-8b", "decode_32k", False',
        f'D.run_cell("deepseek-v2-236b", "decode_32k", {mp}'))
        for mp in (False, True)]
    single, multi = (_finish_cell(p, chips) for p, chips in
                     zip(procs, (256, 512)))
    for r, ref, chips, flops in ((single, refs[0], 256, 298_482_892_800),
                                 (multi, refs[1], 512, 155_331_379_200)):
        assert ref["status"] == "ok" and ref["chips"] == chips
        assert r["step_kind"] == "decode" and r["tokens_per_step"] == 128
        assert r["flops_per_device"] == ref["dot_flops"] == flops
        assert r["collective_bytes_per_device"] \
            < ref["collective_bytes_per_device"]
        assert "all-to-all" in r["collectives"]


TRAIN_CELLS = ("llama4-scout-17b-a16e", "deepseek-v2-236b")
# pod2x16x16 train_4k: the parent's (flops, collective bytes) a device,
# the JAX package's collective bytes, and the largest share of the
# parent's bytes the change may move
MULTI_PARENT = {
    "llama4-scout-17b-a16e": (424_312_653_742_080, 5_848_802_002_960),
    "deepseek-v2-236b": (706_758_726_647_808, 23_468_974_913_808),
}
MULTI_JAX_BYTES = {"llama4-scout-17b-a16e": 2_190_822_297_204,
                   "deepseek-v2-236b": 5_622_037_168_044}
MULTI_BYTES_RATIO = {"llama4-scout-17b-a16e": 0.75,
                     "deepseek-v2-236b": 0.5}


@pytest.fixture(scope="module")
def multi_pod_train_cells():
    """``train_4k`` of both configurations on ``pod2x16x16``, each in a
    process of its own, the two started together."""
    procs = {a: _start_cell(a, "train_4k", multi_pod=True)
             for a in TRAIN_CELLS}
    return {a: _finish_cell(p, chips=512) for a, p in procs.items()}


@pytest.mark.parametrize("arch", TRAIN_CELLS)
def test_multi_pod_train_cell(multi_pod_train_cells, arch):
    """The 256 rows of 4,096 tokens split 32 ways over ``pod`` and
    ``data``: the routed experts' flattened tokens and (llama4-scout)
    the merged heads, 40 over 16 ``model`` ranks, or (deepseek-v2) the
    MLA down-projections get their gradients back placed as their
    forward values were, so the backward views and products trace.  A
    step's flops exceed 6 flops per active parameter and token (the
    rank's share of the tokens) and stay within 8 times that: attention
    (deepseek-v2's plain attention multiplies the whole 4,096-token
    square over 128 heads of 320 dims, about twice the parameters'
    flops), the recomputed blocks and the experts' slack capacity add
    the rest.  The MoE layers move entries by all-to-all, gather no
    "model" rank's share of the expert rows, keep the parent's flops
    within 1.01 and move at most 0.75 (llama4-scout) / 0.5 (deepseek-v2)
    of its collective bytes; the parent's were 2.67 / 4.17 times the
    JAX package's totals, the change's are 0.12 / 0.08 of them."""
    from test_torch_dryrun_moe_split import check_split_moe

    r = multi_pod_train_cells[arch]
    flops, coll = MULTI_PARENT[arch]
    check_split_moe(r, arch, flops)
    assert r["collective_bytes_per_device"] <= MULTI_BYTES_RATIO[arch] * coll
    assert r["collective_bytes_per_device"] < MULTI_JAX_BYTES[arch]
    assert r["step_kind"] == "train" and r["tokens_per_step"] == 256 * 4096
    model = 6 * r["params_active"] * r["tokens_per_step"] / 512
    assert model < r["flops_per_device"] < 8 * model
    if arch == "llama4-scout-17b-a16e":
        assert r["kernel_calls"] == {"flash_attention": 192}
    else:
        assert r["kernel_calls"] == {}
