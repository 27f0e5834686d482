"""The check of the checks: a whole run on the CPU at a tiny size (the
harness's look for a card skipped), with the program's timed path broken
underneath, has to come out not correct, once for each fault the cell can
have; and the control, the reference in fp8 put in the program's place,
has to fail the cell's limits. The same at the cells' own sizes on the
card (``-m card``)."""
import pytest
import torch
# the port's modules bind each other's names when first imported: import
# them all before a test patches one
import marlgrid_tpu_torch.parallel.train  # noqa: F401

from portbench import calibrate, harness
from portbench.reference import follow

from test_portbench_rehearsal import TINY, rehearse


pytestmark = pytest.mark.usefixtures("cpu_as_card")


def _half_batch_loss(ppo):
    def loss(logits, value, lab, cfg, axis=None, share=None):
        adv = lab["adv"]
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)

        def mean(x):
            x = x.reshape(-1)
            return x[: x.numel() // 2].mean()

        pg, vf, ent, dev = (mean(x) for x in ppo.ppo_terms(
            logits, value, lab, adv, cfg))
        return pg + cfg.vf_coef * vf - cfg.ent_coef * ent, dict(
            pg_loss=pg, vf_loss=vf, entropy=ent, ratio_dev=dev)
    return loss


def _unchanged_learner(ppo):
    real = ppo.make_optimizer

    def make(net, cfg):
        opt = real(net, cfg)
        opt.step = lambda *a, **k: None
        return opt
    return make


def _envs_stepped(step, part):
    """``step_autoreset_with_fresh_batch`` that keeps the state of every env
    past ``part`` of the batch unchanged (``part`` 0: the whole batch)."""
    from marlgrid_tpu_torch.core.state import FIELDS, EnvState

    real = step.step_autoreset_with_fresh_batch

    def broken(ep, state, *a, **k):
        new, rew, done, info = real(ep, state, *a, **k)
        n = int(state.step_count.shape[0] * part)
        return EnvState(**{f: torch.cat([getattr(new, f)[:n],
                                         getattr(state, f)[n:]])
                           for f in FIELDS}), rew, done, info
    return broken


def _token_altered(rng):
    real = rng.categorical

    def broken(key, logits, axis=-1):
        a = real(key, logits, axis).clone()
        a.view(-1)[0] = (a.view(-1)[0] + 1) % logits.shape[-1]
        return a
    return broken


def test_train_step_unchanged(bench_path, monkeypatch):
    from marlgrid_tpu_torch.parallel import ppo
    monkeypatch.setattr(ppo, "make_optimizer", _unchanged_learner(ppo))
    r = rehearse(bench_path, "train.goal_cycle_encode")
    assert not r["correct"], r["checks"]


def test_train_half_batch(bench_path, monkeypatch):
    from marlgrid_tpu_torch.parallel import ppo
    monkeypatch.setattr(ppo, "ppo_loss", _half_batch_loss(ppo))
    r = rehearse(bench_path, "train.goal_cycle_encode")
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("part", [0.0, 0.5])
def test_rollout_state_unchanged_or_half(bench_path, monkeypatch, part):
    from marlgrid_tpu_torch.core import step
    monkeypatch.setattr(step, "step_autoreset_with_fresh_batch",
                        _envs_stepped(step, part))
    r = rehearse(bench_path, "rollout.goal_cycle_encode")
    assert not r["correct"], r["checks"]
    assert r["checks"]["env_mismatch"]["value"] > 0


def test_rollout_token_altered(bench_path, monkeypatch):
    from marlgrid_tpu_torch.core import rng
    monkeypatch.setattr(rng, "categorical", _token_altered(rng))
    r = rehearse(bench_path, "rollout.goal_cycle_encode")
    assert not r["correct"], r["checks"]


def _fails(readings, limits):
    return any(readings[k] > limits[k] for k in limits)


@pytest.mark.parametrize("cell", sorted(TINY))
def test_control_fails_the_limits(bench_path, cell):
    _, config, traffic, limits, _, _ = harness.load(bench_path, cell)
    traffic = dict(traffic, **TINY[cell], warmup_seconds=0)
    r = calibrate.in_place(config, traffic, 21, torch.device("cpu"),
                           quant=follow.fp8)
    assert _fails(r, limits), (r, limits)


@pytest.mark.card
@pytest.mark.parametrize("cell", sorted(TINY))
def test_control_at_the_cells_size(bench_path, cell, card):
    _, config, traffic, limits, _, _ = harness.load(bench_path, cell)
    for seed in range(3):
        r = calibrate.in_place(config, traffic, 4_000_000_000 + seed, card,
                               quant=follow.fp8)
        assert _fails(r, limits), (seed, r, limits)
