"""The port's dry run where the kv heads do not split over the model
axis (``repro_torch.launch.dryrun``), against the JAX package's
partitioned HLO: granite-8b and gemma3-1b ``prefill_32k`` and gemma3-1b
``long_500k`` on ``pod16x16``.  No model rank repeats another's
attention, no rank gathers a KV cache or the embedding table.  Each
cell runs in a subprocess of its own (the fake process group belongs
to the process), as in ``tests/test_torch_dryrun.py``; a file of its own
so that its cells run beside that file's."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_dryrun import _REFERENCE, _ok, _port_cell, _run  # noqa: E402

T = 32768


def _reference(arch: str, shape: str) -> dict:
    ref = _run(_REFERENCE.replace('"granite-8b", "decode_32k"',
                                  f'"{arch}", "{shape}"'))
    assert ref["status"] == "ok" and ref["chips"] == 256
    return ref


def test_granite_prefill_splits_the_heads_of_each_kv_head():
    """32 q heads over 8 kv heads and 16 model ranks: each rank attends
    its 2 q heads (and 2 of the 32 rows) against the one kv head they
    read, causal pairs only.  Every other product equals the JAX
    package's dots; its attention multiplies the same 2 heads over the
    whole square."""
    from repro_torch.kernels.flash_attention.kernel import attended_pairs

    r = _port_cell("granite-8b", "prefill_32k", False)
    _ok(r)
    assert r["kernel_calls"] == {"flash_attention": 36}
    attention = 36 * 4 * 2 * 2 * 128 * attended_pairs(T, T, True, None)
    assert r["flops_per_device"] == 105_554_324_226_048 \
        == 65_970_697_666_560 + attention
    ref = _reference("granite-8b", "prefill_32k")
    ref_attention = 36 * 4 * 2 * 2 * T * T * 128
    assert r["flops_per_device"] - attention \
        == ref["dot_flops"] - ref_attention == 65_970_697_666_560


def test_gemma3_prefill_attends_zigzag_query_chunks():
    """4 q heads over one kv head and 16 model ranks: d = gcd(4, 16) = 4
    parts of the q heads, c = 4 shards of the queries, so rank 0 attends
    q head 0 over query chunks 0 and 7 of 8 (4,096 rows each), each
    against its key prefix (from the window's first key on the local
    layers): the flop formula over those chunks, 2 kernel calls a layer.
    Every other product equals the JAX package's dots, whose attention
    is the whole square over 16 ranks."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.kernel import attended_pairs
    from repro_torch.kernels.flash_attention.ops import zigzag_chunks

    cfg = get_config("gemma3-1b")
    r = _port_cell("gemma3-1b", "prefill_32k", False)
    _ok(r)
    assert r["kernel_calls"] == {"flash_attention": 2 * cfg.n_layers}
    rows, d = 32 // 16, cfg.head_dim
    attention = 0
    for kind in cfg.layer_kinds():
        window = cfg.window if kind == "local" else None
        for a, size, lo, hi in zigzag_chunks(T, T, 4, 0, window):
            attention += 4 * rows * 1 * d * attended_pairs(
                size, hi - lo, True, window)
    assert r["flops_per_device"] - attention == 8_189_965_762_560
    ref = _reference("gemma3-1b", "prefill_32k")
    ref_attention = cfg.n_layers * 4 * rows * cfg.n_heads * T * T * d // 16
    assert ref["dot_flops"] - ref_attention == 8_189_965_762_560
    # a sixteenth of all 4 heads' causal work on the rank's rows
    whole = sum(4 * rows * cfg.n_heads * d * attended_pairs(
        T, T, True, cfg.window if kind == "local" else None)
        for kind in cfg.layer_kinds())
    assert attention * 16 == pytest.approx(whole, rel=0.01)


def test_gemma3_long_context_decode_merges_key_shards():
    """One row at a 524,288-slot cache: the cache's slots split over
    ``data``, and inside each shard the 16 model ranks that share the
    kv head split its 4 q heads 4 ways and its slots 4 ways; the shards
    merge by their log-sum-exps.  No all-gather is as large as a rank's
    shard of a rolling local cache (32 of 512 slots), which is the
    smallest cache shard; the collective bytes are below the JAX
    package's; the flops equal its dots."""
    from repro_torch.configs import get_config

    cfg = get_config("gemma3-1b")
    r = _port_cell("gemma3-1b", "long_500k", False)
    _ok(r)
    assert r["kernel_calls"] == {"decode_attention": cfg.n_layers}
    local_shard = 1 * 1 * (cfg.window // 16) * cfg.head_dim * 2
    assert r["collective_largest"]["all-gather"] < local_shard
    ref = _reference("gemma3-1b", "long_500k")
    assert r["collective_bytes_per_device"] \
        < ref["collective_bytes_per_device"] == 85_206_416
    assert r["flops_per_device"] == ref["dot_flops"] == 158_703_616
