"""The check has teeth: a run whose timed path is broken underneath comes
out not correct, once for each fault the cell can have.  The harness's look
for a card is skipped; everything else runs as on the card, at a tiny
width and in float32 (where a sound run is correct: see
test_portbench_cells.py)."""

import pytest

from conftest import cells, run_tiny, tiny_cell

TRAIN = [c for c in cells() if c.endswith(("train_b16", "train_dp4"))]


def no_update(opt, params, grads, mesh=None, layout=None):
    """A step that returns its state unchanged: no optimizer step."""


@pytest.mark.parametrize("name", TRAIN)
def test_step_leaving_the_state_unchanged_is_caught(name, monkeypatch):
    from transeditor_tpu_torch.train import gan
    monkeypatch.setattr(gan, "_apply", no_update)
    out, run = run_tiny(tiny_cell(name, dtype="float32"))
    assert not out["correct"]
    assert out["compared"]["change_gap"]["value"] > \
        out["compared"]["change_gap"]["limit"]


@pytest.mark.parametrize("name", TRAIN)
def test_half_the_batch_left_out_is_caught(name, monkeypatch):
    from transeditor_tpu_torch.train import losses
    d_loss, g_loss = losses.d_logistic_loss, losses.g_nonsaturating_loss

    def half(t):
        return t[:max(1, t.shape[0] // 2)]

    monkeypatch.setattr(losses, "d_logistic_loss",
                        lambda r, f: d_loss(half(r), half(f)))
    monkeypatch.setattr(losses, "g_nonsaturating_loss",
                        lambda f: g_loss(half(f)))
    out, run = run_tiny(tiny_cell(name, dtype="float32"))
    assert not out["correct"]
