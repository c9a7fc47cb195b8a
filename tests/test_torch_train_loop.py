"""The port's trainer: the reference tests' fault tolerance (a run
preempted after 8 steps and resumed equals an uninterrupted 12-step
run bitwise; 60 steps lower the loss by more than 0.3), its loss curve
against the JAX package's trainer from the same parameters, the launch
CLI, and the default device."""
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.data.pipeline import DataConfig as JDataConfig
from repro.train.optimizer import OptConfig as JOptConfig
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro.train.trainer import train as j_train
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch import train as launch_train
from repro_torch.models.common import named_leaves
from repro_torch.models.model import init_params
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.trainer import PreemptionError, TrainerConfig, train
from torch_parity import one_torch_thread  # noqa: F401
from torch_train_parity import reference_tree

pytestmark = pytest.mark.usefixtures("one_torch_thread")
CPU = "cpu"
# the two trainers' loss curves, f32: each AdamW step differs a little
# (see torch_train_parity.py) and the differences carry on; about 7e-8
# relative measured over 6 steps
CURVE_RTOL = 1e-5


def _cfgs(ckpt_dir, fail_after=None, steps=12):
    cfg = get_config("gemma3-1b-smoke")
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=2)
    opt = OptConfig(peak_lr=1e-3, warmup_steps=2, decay_steps=12)
    t = TrainerConfig(total_steps=steps, ckpt_every=4, ckpt_dir=ckpt_dir,
                      log_every=2, fail_after_step=fail_after)
    return cfg, data, opt, t


def test_preemption_resume_is_bitwise(tmp_path):
    r_full = train(*_cfgs(str(tmp_path / "a")), device=CPU)
    with pytest.raises(PreemptionError):
        train(*_cfgs(str(tmp_path / "b"), fail_after=8), device=CPU)
    r_res = train(*_cfgs(str(tmp_path / "b")), device=CPU)
    assert r_res.resumed_from == 8 and r_res.final_step == 12
    for (k, a), (_, b) in zip(named_leaves(r_full.params),
                              named_leaves(r_res.params)):
        assert a.requires_grad and b.requires_grad, k
        assert torch.equal(a, b), k
    for part in ("m", "v"):
        for (k, a), (_, b) in zip(named_leaves(r_full.opt_state[part]),
                                  named_leaves(r_res.opt_state[part])):
            assert torch.equal(a, b), (part, k)
    assert int(r_full.opt_state["step"]) == int(r_res.opt_state["step"]) \
        == 12
    # the resumed run logs the same steps and losses from step 8 on
    tail = [m for m in r_full.metrics_log if m["step"] >= 8]
    assert [(m["step"], m["loss"]) for m in tail] == \
        [(m["step"], m["loss"]) for m in r_res.metrics_log]


def test_loss_decreases_over_training(tmp_path):
    from dataclasses import replace

    cfg = replace(get_config("gemma3-1b-smoke"), vocab_size=128)
    data = DataConfig(vocab_size=64, seq_len=32, global_batch=4)
    opt = OptConfig(peak_lr=5e-3, warmup_steps=5, decay_steps=60)
    t = TrainerConfig(total_steps=60, ckpt_every=1000,
                      ckpt_dir=str(tmp_path), log_every=5)
    r = train(cfg, data, opt, t, device=CPU)
    first = r.metrics_log[0]["loss"]
    last = min(m["loss"] for m in r.metrics_log[-3:])
    assert last < first - 0.3, (first, last)


def test_loss_curve_matches_the_reference_trainer(tmp_path):
    cfg = get_config("granite-8b-smoke")
    params = init_params(cfg, 0, CPU, masters=True)
    jparams = jax.tree.map(jnp.asarray, reference_tree(params))
    kw = dict(vocab_size=cfg.vocab_size, seq_len=32, global_batch=2)
    opt = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=6)
    tkw = dict(total_steps=6, ckpt_every=100, log_every=1)
    want = j_train(cfg, JDataConfig(**kw), JOptConfig(**opt),
                   JTrainerConfig(ckpt_dir=str(tmp_path / "j"), **tkw),
                   params=jparams)
    got = train(cfg, DataConfig(**kw), OptConfig(**opt),
                TrainerConfig(ckpt_dir=str(tmp_path / "t"), **tkw),
                params=params, device=CPU)
    assert [m["step"] for m in got.metrics_log] == list(range(6))
    for a, b in zip(got.metrics_log, want.metrics_log):
        assert a["lr"] == pytest.approx(b["lr"], rel=1e-6)
        assert abs(a["loss"] - b["loss"]) <= CURVE_RTOL * b["loss"], (a, b)


def test_launch_cli_trains_and_resumes(tmp_path, capsys):
    args = ["--arch", "granite-8b-smoke", "--steps", "4", "--seq-len", "32",
            "--global-batch", "2", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2", "--device", "cpu", "--grad-compress"]
    launch_train.main(args)
    out = capsys.readouterr().out
    assert "finished at step 4" in out and "resumed" not in out
    launch_train.main([*args[:3], "6", *args[4:]])
    assert "finished at step 6 (resumed from 4)" in capsys.readouterr().out


def test_entry_points_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device runs")
    cfg, data, opt, t = _cfgs(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train(cfg, data, opt, t)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(cfg, 0, masters=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_train.main(["--arch", "granite-8b-smoke", "--steps", "1",
                           "--ckpt-dir", str(tmp_path)])
