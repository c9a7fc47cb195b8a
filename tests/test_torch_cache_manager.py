"""CacheManager budget/spill accounting (regression tests)."""
import pytest

from repro_torch.core.cache import CacheManager

from torch_parity import one_torch_thread  # noqa: F401


def _mk(budget=100):
    # identity spill/unspill: enough to exercise the accounting paths
    return CacheManager(budget, spill_fn=lambda p: p, unspill_fn=lambda p: p)


class TestAccounting:
    def test_put_within_budget(self):
        cm = _mk(100)
        cm.put(b"a", "A", nbytes=60)
        assert cm.stats.used == 60 and cm.stats.spilled_bytes == 0

    def test_overflow_spills(self):
        cm = _mk(100)
        cm.put(b"a", "A", nbytes=60)
        e = cm.put(b"b", "B", nbytes=60)
        assert e.spilled
        assert cm.stats.used == 60 and cm.stats.spilled_bytes == 60

    def test_evict_resident_entry(self):
        cm = _mk(100)
        cm.put(b"a", "A", nbytes=60)
        cm.evict(b"a")
        assert cm.stats.used == 0
        assert not cm.contains(b"a")

    def test_evict_spilled_entry_resets_spilled_bytes(self):
        cm = _mk(100)
        cm.put(b"a", "A", nbytes=60)
        cm.put(b"b", "B", nbytes=60)          # spilled
        cm.evict(b"b")
        assert cm.stats.spilled_bytes == 0
        assert cm.stats.used == 60

    def test_evict_missing_is_noop(self):
        cm = _mk(100)
        cm.put(b"a", "A", nbytes=60)
        cm.evict(b"nope")
        assert cm.stats.used == 60 and cm.stats.spilled_bytes == 0

    def test_clear_resets_both_counters(self):
        cm = _mk(100)
        cm.put(b"a", "A", nbytes=60)
        cm.put(b"b", "B", nbytes=60)          # spilled
        cm.clear()
        assert cm.stats.used == 0
        assert cm.stats.spilled_bytes == 0
        assert not cm.contains(b"a") and not cm.contains(b"b")
        # cache stays usable after clear
        cm.put(b"c", "C", nbytes=60)
        assert cm.stats.used == 60 and cm.stats.spilled_bytes == 0

    def test_get_unspills(self):
        cm = _mk(100)
        cm.put(b"a", "A", nbytes=60)
        cm.put(b"b", "B", nbytes=60)
        assert cm.get(b"b") == "B"
        assert cm.stats.hits == 1

    def test_no_promotion_without_headroom(self):
        cm = _mk(100)
        cm.put(b"a", "A", nbytes=60)
        cm.put(b"b", "B", nbytes=60)          # spilled
        cm.get(b"b")                          # 40 free < 60: stays spilled
        assert cm.entry(b"b").spilled
        assert cm.stats.used == 60 and cm.stats.spilled_bytes == 60
        assert cm.stats.promotions == 0

    def test_hit_promotes_spilled_entry_when_budget_frees(self):
        """Satellite fix (ISSUE 2): a spilled entry used to be
        re-unspilled on EVERY hit and never moved back to device even
        when the budget freed up."""
        cm = _mk(100)
        cm.put(b"a", "A", nbytes=60)
        cm.put(b"b", "B", nbytes=60)          # spilled
        cm.evict(b"a")                        # headroom appears
        assert cm.get(b"b") == "B"
        e = cm.entry(b"b")
        assert not e.spilled                  # promoted to device
        assert cm.stats.used == 60
        assert cm.stats.spilled_bytes == 0
        assert cm.stats.promotions == 1
        # subsequent hits read device-resident payload, no unspill work
        assert cm.get(b"b") == "B"
        assert cm.stats.promotions == 1


pytestmark = pytest.mark.usefixtures("one_torch_thread")
