"""The single-device engine chooser and the engines ``driver=`` accepts."""

import pytest

from tpulp.corpus import get_case
from tpulp.solve import solve_lp
from tpulp.solve import api
from tpulp.solve.api import BLOCKED_MIN_ELEMS, ENGINES, choose_engine


@pytest.mark.parametrize("m,n,pricing,rung,expected", [
    (2, 4, "default", "device", "rank1"),
    (64, 128, "devex", "device", "rank1"),
    (300, 600, "default", "device", "rank1"),
    (320, 640, "default", "device", "blocked"),
    (4096, 8192, "default", "device", "blocked"),
    (4096, 8192, "devex", "device", "blocked"),
    (64, 128, "default", "refreshed", "rank1"),
    (64, 128, "devex", "refreshed", "blocked"),
    (4096, 8192, "default", "refreshed", "blocked"),
    # the threshold itself: (398+2) x (499+1) = 200,000 tableau elements
    (398, 499, "default", "device", "blocked"),
    (398, 498, "default", "device", "rank1"),
])
def test_choose_engine(m, n, pricing, rung, expected):
    assert choose_engine(m, n, pricing, rung) == expected


def test_threshold_is_tableau_elements():
    assert (398 + 2) * (499 + 1) == BLOCKED_MIN_ELEMS


def test_unknown_rung_raises():
    with pytest.raises(ValueError, match="rung"):
        choose_engine(10, 20, rung="pallas")


def test_pallas_driver_raises_naming_the_engines():
    with pytest.raises(ValueError) as info:
        solve_lp(get_case("textbook").lp(), driver="pallas")
    for eng in ENGINES:
        assert repr(eng) in str(info.value)


def test_auto_driver_asks_the_chooser(monkeypatch):
    calls = []

    def spy(m, n, pricing="default", rung="device"):
        calls.append((m, n, pricing, rung))
        return "blocked"

    monkeypatch.setattr(api, "choose_engine", spy)
    case = get_case("textbook")
    sol = solve_lp(case.lp(), block=4)
    assert sol.objective == case.objective
    assert calls and calls[0][3] == "device"
