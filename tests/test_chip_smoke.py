"""chip_smoke.py rehearsed on the CPU: its contract line, its refusal to
run off the GPU, and every phase at a tiny size (phase h, which runs the
``gpu``-marked tests, only means something on the card)."""

import json

import pytest

import jax
import jax.numpy as jnp

import chip_smoke


def test_contract_line_is_exactly_the_contract():
    line = chip_smoke.contract_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert line == ('{"ok": true, "device": {"platform": "gpu", '
                    '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}')
    assert json.loads(line)["device"]["count"] == 1


def test_exits_nonzero_without_a_gpu(capsys):
    assert chip_smoke.main([]) != 0
    assert capsys.readouterr().out == ""


def test_rel_gap_is_exact():
    from fractions import Fraction

    assert chip_smoke.rel_gap(Fraction(1, 3), Fraction(1, 3)) == 0.0
    assert chip_smoke.rel_gap(2.0, 1.0) == 1.0
    with pytest.raises(AssertionError):
        chip_smoke.report("x", "demo", "ref", 1e-9, 1e-3)


def test_phase_device(capsys):
    card = chip_smoke.phase_device(lambda: [["Test Card", "123.00 W"]])
    assert card == "Test Card, 123.00 W"
    assert "platform=cpu" in capsys.readouterr().out


def test_phase_user_surface():
    chip_smoke.phase_user_surface()


def test_phase_certified_tiny():
    chip_smoke.phase_certified(m=24, n=48, seed=7, corpus=False)


def test_phase_hot_path_tiny():
    chip_smoke.phase_hot_path(m=48, n=48, pivots=24, block=8,
                              expect_engine="rank1")


def test_phase_batch_tiny():
    chip_smoke.phase_batch(lanes=4, m=12, n=12)


def test_phase_milp_tiny():
    chip_smoke.phase_milp(n_items=10, batch_size=16)


def test_phase_precision_tiny():
    chip_smoke.phase_precision(m=24, n_struct=48, lanes=2, n_int=8)


def test_phase_multicard_tiny():
    assert len(jax.devices()) >= 4
    chip_smoke.phase_multicard(cards=4, m_eq=24, n_eq=48, m=48, n=48,
                               pivots=24, lanes=4, m_b=12, n_b=12,
                               n_items=10, batch_size=16)
