"""A run with the timed path broken underneath comes out not correct,
once for each fault a cell can have: a step that returns its state
unchanged, half of the batch left out, the exchange between cards left
out, and an answer altered where it is produced.  The harness's look for
a card is skipped (the run is on the CPU); the rest of a run is driven."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import ebhelp  # noqa: E402
from tpu_ecm_torch import driver, stage1  # noqa: E402
from tpu_ecm_torch.stage2 import exec as s2exec  # noqa: E402


def _wrong(out, *numbers):
    assert out["correct"] is False
    for name in numbers:
        assert out["checks"][name]["value"] > 0, (name, out["checks"])


def test_sound_run_is_correct():
    assert ebhelp.run_tiny(ebhelp.tiny_cell(devices=2))["correct"] is True


def test_state_unchanged(monkeypatch):
    real = stage1.run_stage1

    def frozen(states, run_tapes, *a, **k):
        return real(states, [lambda pts, tape, s: None] * len(run_tapes),
                    *a, **k)
    monkeypatch.setattr(stage1, "run_stage1", frozen)
    _wrong(ebhelp.run_tiny(ebhelp.tiny_cell()), "stage1_mismatch")


def test_half_the_batch_left_out(monkeypatch):
    real = stage1.run_stage1

    def half(states, run_tapes, *a, **k):
        def first_half(run_tape):
            def run(pts, tape, s):
                full = pts.clone()
                run_tape(full, tape, s)
                h = pts.shape[-1] // 2
                pts[..., :h] = full[..., :h]
            return run
        return real(states, [first_half(r) for r in run_tapes], *a, **k)
    monkeypatch.setattr(stage1, "run_stage1", half)
    _wrong(ebhelp.run_tiny(ebhelp.tiny_cell()), "stage1_mismatch")


def test_exchange_between_cards_left_out(monkeypatch):
    real = driver.ECMDriver._extract_point

    def first_card_only(self, states):
        xs, zs = real(self, states[:1])
        return xs * len(states), zs * len(states)
    monkeypatch.setattr(driver.ECMDriver, "_extract_point", first_card_only)
    _wrong(ebhelp.run_tiny(ebhelp.tiny_cell(devices=2)), "stage1_mismatch")


def test_answer_altered(monkeypatch):
    real = s2exec.Stage2Runner.result

    def altered(self):
        r = real(self)
        r.acc = [a + 1 for a in r.acc]
        return r
    monkeypatch.setattr(s2exec.Stage2Runner, "result", altered)
    _wrong(ebhelp.run_tiny(ebhelp.tiny_cell()), "stage2_mismatch")
