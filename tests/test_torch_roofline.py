"""The port's roofline module: the JAX package's term arithmetic
(``tests/test_roofline.py``'s ``TestRooflineTerms`` cases) against each
H100 part's peaks, the peaks chosen by device name, and the allocator
peak in place of XLA's memory analysis."""
import pytest
import torch

from repro.launch import roofline as R
from repro_torch.launch.roofline import (hardware, roofline_terms,
                                         summarize_memory)

NAMES = ("NVIDIA H100 80GB HBM3", "NVIDIA H100 PCIe", "NVIDIA H100 NVL")


def _cell(flops, bytes_, coll, chips=256, active=1e9, tokens=1e6,
          kind="train"):
    return {"flops_per_device": flops, "bytes_accessed_per_device": bytes_,
            "collective_bytes_per_device": coll, "chips": chips,
            "params_active": active, "tokens_per_step": tokens,
            "step_kind": kind}


@pytest.fixture(params=NAMES)
def card(request):
    hw = hardware(request.param)
    return request.param, hw.bf16_flops_per_s, hw.hbm_bytes_per_s, \
        hw.nvlink_bytes_per_s


class TestRooflineTerms:
    def test_term_math(self, card):
        name, peak, hbm, link = card
        r = roofline_terms(_cell(peak, hbm, link), name)
        assert r["compute_s"] == pytest.approx(1.0)
        assert r["memory_s"] == pytest.approx(1.0)
        assert r["collective_s"] == pytest.approx(1.0)

    def test_dominant_selection(self, card):
        name, peak, hbm, link = card
        assert roofline_terms(_cell(peak, hbm * 3, link),
                              name)["dominant"] == "memory"
        assert roofline_terms(_cell(peak * 5, hbm, link),
                              name)["dominant"] == "compute"
        assert roofline_terms(_cell(peak, hbm, link * 9),
                              name)["dominant"] == "collective"

    def test_useful_ratio(self, card):
        cell = _cell(flops=6e9 * 1e6 * 1 / 256, bytes_=1, coll=1,
                     active=1e9, tokens=1e6)
        assert roofline_terms(cell, card[0])["useful_flops_ratio"] \
            == pytest.approx(1.0)

    def test_inference_multiplier(self, card):
        train = roofline_terms(_cell(1e12, 1, 1, kind="train"), card[0])
        serve = roofline_terms(_cell(1e12, 1, 1, kind="decode"), card[0])
        assert train["model_flops_total"] == 3 * serve["model_flops_total"]

    def test_mfu_at_roofline_is_one(self, card):
        cell = _cell(flops=6e9 * 1e6 / 256, bytes_=0, coll=0)
        assert roofline_terms(cell, card[0])["roofline_fraction_mfu"] \
            == pytest.approx(1.0)


@pytest.mark.parametrize("cell", [
    _cell(3e13, 2e11, 4e9), _cell(1e10, 5e12, 0, chips=1, kind="decode"),
    _cell(2e14, 1e9, 9e11, chips=4)])
def test_arithmetic_equals_the_jax_package_at_its_peaks(cell,
                                                        monkeypatch):
    """With the reference's v5e peaks put in the table, the port's terms
    are the reference's, key for key."""
    from repro_torch.launch import roofline as P

    v5e = P.Hardware("v5e", R.PEAK_FLOPS, 0.0, R.HBM_BW, R.ICI_BW, 0)
    monkeypatch.setattr(P, "hardware", lambda name: v5e)
    got = P.roofline_terms(cell, "v5e")
    assert got.pop("device") == "v5e"
    assert got == R.roofline_terms(cell)


@pytest.mark.parametrize("name,part,bf16,hbm", [
    ("NVIDIA H100 80GB HBM3", "H100 SXM", 989e12, 3.35e12),
    ("NVIDIA H100 PCIe", "H100 PCIe", 756e12, 2.0e12),
    ("NVIDIA H100 NVL", "H100 NVL", 835e12, 3.9e12)])
def test_hardware_by_name(name, part, bf16, hbm):
    hw = hardware(name)
    assert (hw.part, hw.bf16_flops_per_s, hw.hbm_bytes_per_s) == \
        (part, bf16, hbm)
    # f32 outside the tensor cores is far below the bf16 tensor cores
    assert hw.f32_flops_per_s < hw.bf16_flops_per_s / 10


@pytest.mark.parametrize("name", ["NVIDIA A100-SXM4-80GB", "Tesla V100",
                                  "", "NVIDIA H200"])
def test_unknown_device_raises(name):
    with pytest.raises(ValueError, match="no published peaks"):
        hardware(name)


def test_device_name_from_the_cell_or_refused():
    cell = _cell(1e12, 1e9, 0)
    assert roofline_terms({**cell, "device": NAMES[1]}) == \
        roofline_terms(cell, NAMES[1])
    with pytest.raises(ValueError, match="device name"):
        roofline_terms(cell)
    with pytest.raises(ValueError, match="no published peaks"):
        roofline_terms({**cell, "device": "NVIDIA A100"})


def test_summarize_memory_reads_the_allocator():
    assert summarize_memory("cpu") == {}
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()
        x = torch.empty(1 << 20, device="cuda")
        got = summarize_memory("cuda")
        assert got["peak_bytes_per_device_est"] >= x.numel() * 4
