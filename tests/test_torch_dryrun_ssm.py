"""The port's dry run of the SSM cells (``repro_torch.launch.dryrun``):
falcon-mamba-7b ``prefill_32k`` and recurrentgemma-9b ``train_4k`` on
``pod16x16``, whose time scans trace as one custom operator a layer
(``models/scan_ops.py``) where the plain loops dispatch every one of
their 32,768 / 4,096 steps.  Each cell runs in a subprocess of its own,
as in ``tests/test_torch_dryrun_split.py``, whose helpers it reuses.

The JAX package's figure counts the time scan's body once a layer: its
``lax.scan`` is a while loop of 32,768 trips (``known_trip_count`` in the
HLO) whose body XLA's cost analysis and the HLO dot counter both read
once, and the JAX package's probe multiplies only the layer scan's trips
(``repro/launch/dryrun.py::_scan_body_probe``).  The port counts every
step.  So the cells compare the split, not the totals.
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_dryrun import _REFERENCE, _ok, _run  # noqa: E402

T = 32768

# the JAX reference cell, plus the flops of the dots that lie in the
# time scan's body (the einsum "bds,bs->bd"), counted as the module and
# the probe count them
_SCAN_DOTS = '''
def scan_dot_flops(hlo):
    return dot_flops("\\n".join(ln for ln in hlo.splitlines()
                               if " dot(" not in ln or "bds,bs->bd" in ln))


r["scan_dot_flops"] = scan_dot_flops(texts[0]) \\
    + (trips - 1) * scan_dot_flops(texts[1])
r["scan_trips"] = sorted(set(re.findall(r'"known_trip_count":\\{"n":"(\\d+)"',
                                        texts[0])))
r["long_ok"] ='''

# the port's cell, with a spy on the scans' inputs: each one's placements
# before and after it is moved to the rank's rows and channels
_PORT = '''
import json
from repro_torch.launch.dryrun import run_cell
from repro_torch.models import scan_ops

moves = []
real = scan_ops._local


def spy(x, mesh, pls, split):
    before = getattr(x, "placements", None)
    moves.append([str(before), str(tuple(pls)), list(x.shape)])
    return real(x, mesh, pls, split)


scan_ops._local = spy
r = run_cell("{arch}", "{shape}", multi_pod=False, save=False)
r["scan_input_moves"] = moves
print("RESULT_JSON:" + json.dumps(r, default=str))
'''


def _port_cell(arch: str, shape: str) -> dict:
    return _run(_PORT.replace("{arch}", arch).replace("{shape}", shape))


def _reference(arch: str, shape: str) -> dict:
    code = _REFERENCE.replace('"granite-8b", "decode_32k"',
                              f'"{arch}", "{shape}"')
    ref = _run(code.replace('r["long_ok"] =', _SCAN_DOTS, 1))
    assert ref["status"] == "ok" and ref["chips"] == 256
    return ref


def _no_gathered_scan_input(r: dict) -> None:
    """Every (B, T, C) input of a scan (and of the causal convolution
    before it) reaches its rank's rows and channels without a gather: a
    mesh dim that splits it before still splits it after (only a partial
    sum, Bm / Cm's, is made whole, by an all-reduce).  The parameters
    (A, D, the convolution's weights) follow the channels' split, and
    are gathered where a block splits its rows over every mesh dim."""
    moves = [m for m in r["scan_input_moves"] if len(m[2]) == 3]
    assert moves
    for before, after, shape in moves:
        for src, dst in zip(before.strip("()").split("), "),
                            after.strip("()").split("), ")):
            if src.startswith("Shard"):
                assert dst.startswith("Shard"), (before, after, shape)


def test_falcon_mamba_prefill_splits_products_and_scans():
    """64 layers, rank 0's 2 rows and 512 of d_inner's 8,192 channels.
    The port's products equal the JAX package's dots less its scan body,
    which the JAX figure counts once a layer (2 x 512 outputs over 16
    states); the scans count the formula over all 32,768 steps.  The
    largest collectives are the blocks' summed (B, T, d) outputs and the
    in-projection weight's gather, not a scan input (its full width, (2,
    T, 8,192) bf16, is 1 GiB)."""
    from repro_torch.models.scan_ops import ssm_scan_flops

    r = _port_cell("falcon-mamba-7b", "prefill_32k")
    _ok(r)
    assert r["kernel_calls"] == {}
    assert r["operator_calls"] == {"ssm_scan": 64}
    scans = 64 * ssm_scan_flops((2, T, 512), (2, T, 16), (2, T, 16),
                                (2, T, 512), (512, 16), (512,))
    assert scans == 64 * 2 * 2 * T * 512 * 16 == 68_719_476_736
    assert r["flops_per_device"] - scans == 57_294_863_728_640
    ref = _reference("falcon-mamba-7b", "prefill_32k")
    assert ref["scan_trips"] == ["32768", "64"]
    assert ref["scan_dot_flops"] == 64 * 2 * 2 * 512 * 16 == 2_097_152
    assert ref["dot_flops"] - ref["scan_dot_flops"] == 57_294_863_728_640
    assert r["collective_largest"] == {"all-reduce": 2 * T * 4096 * 2,
                                       "all-gather": 4096 * 16384 * 2}
    assert max(r["collective_largest"].values()) < 2 * T * 8192 * 2
    _no_gathered_scan_input(r)


def test_recurrentgemma_train_scans_each_ranks_rows_and_channels():
    """38 layers, 26 of them RG-LRU; block remat runs the 12 pattern
    repeats' forwards again in the backward (24 more scans), and each
    scan's backward is one operator.  The recurrence is elementwise, so
    its operators add no flops.  No scan input is gathered.  The
    residual stream is whole over ``model`` in the backward too, so the
    head reads the tied table where it lies and keeps the logits split
    by vocab: the largest all-reduce is the stream's own sum (rank 0's
    16 rows x 4,096 x 4,096 bf16), where f32 logits over the whole
    vocab (16 x 4,096 x 256,000 x 4) were summed while the stream was
    left partial; the largest all-gathers are the gates' gradients
    gathered back from their channel split (the backward of their
    reduce-scatter), of the same size, and never the table (256,000 x
    4,096 bf16)."""
    r = _port_cell("recurrentgemma-9b", "train_4k")
    _ok(r)
    assert r["operator_calls"] == {"rglru_scan": 50,
                                   "rglru_scan_backward": 26}
    assert r["kernel_calls"] == {"flash_attention": 24}
    _no_gathered_scan_input(r)
    largest = r["collective_largest"]
    assert largest["all-reduce"] == largest["all-gather"] \
        == 16 * 4096 * 4096 * 2
    assert max(largest.values()) < 16 * 4096 * 256000 * 4 // 16
    assert largest["all-gather"] < 256000 * 4096 * 2
