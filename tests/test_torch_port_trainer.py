"""The port's eval steps, checkpoints, synthetic data, CLI and trainer held
against the JAX package on the CPU (the train step is in
test_torch_port_train.py): eval steps with the same injected noise,
checkpoint files loaded across the packages in both directions, the
synthetic data bit for bit, and the trainer writing, logging the JAX
trainer's keys and resuming."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robot_aware_control_tpu.config import Config as JConfig
from robot_aware_control_tpu.data.synthetic import synthetic_batch as jsynthetic_batch
from robot_aware_control_tpu.training import checkpoint as jckpt
from robot_aware_control_tpu.training import step as jstep
from robot_aware_control_tpu_torch import convert
from robot_aware_control_tpu_torch.config import Config, argparser
from robot_aware_control_tpu_torch.data.synthetic import SyntheticDataset, synthetic_batch
from robot_aware_control_tpu_torch.training import checkpoint as tckpt
from robot_aware_control_tpu_torch.training import step as tstep
from robot_aware_control_tpu_torch.training.trainer import PredictionTrainer, main
from torch_train_cases import one_torch_thread  # noqa: F401 (autouse)
from torch_train_cases import (
    JAX_TRAIN_KEYS,
    STEP_KW,
    STEP_TOL,
    fake_jax_normal,
    flat,
    jax_trees,
    port_model,
    port_noise,
    torch_batch,
    window,
)


@pytest.fixture(scope="module")
def jax_side():
    """JAX trees, windows, and the JAX eval steps' results on them (jitted
    once each, with jax.random.normal patched to the injected noise while
    they trace)."""
    jcfg = JConfig(**STEP_KW)
    params, bn = jax_trees(jcfg)
    batch = window(jsynthetic_batch(jcfg, 2, 8, seed=0), 4)
    ebatch = window(synthetic_batch(jcfg, 2, 8, seed=5), 4)
    out = {"params": params, "bn": bn, "batch": batch, "ebatch": ebatch,
           "eval": {}}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal", fake_jax_normal)
        for ar in (True, False):
            per_step, preds = jstep.make_eval_step(jcfg, ar)(
                params, bn, {k: jnp.asarray(v) for k, v in ebatch.items()},
                jax.random.PRNGKey(4))
            out["eval"][ar] = (jax.tree_util.tree_map(np.asarray, per_step),
                               np.asarray(preds))
    return out


# ------------------------------------------------------------- eval step
@pytest.mark.parametrize("autoregressive", [True, False])
def test_eval_step_matches_jax(jax_side, autoregressive):
    """make_eval_step, autoregressive and one-step, the prior driving the
    prediction with the injected noise: per-step metrics and predictions
    to 1e-4 (the port's cells: the kernel's plain version on the CPU)."""
    js = jax_side
    cfg = Config(**STEP_KW)
    jper, jpreds = js["eval"][autoregressive]
    model = port_model(js["params"], js["bn"], cfg)
    per, preds = tstep.make_eval_step(cfg, model, autoregressive)(
        torch_batch(js["ebatch"]), noise=port_noise(3, True))
    assert set(per) == set(jper) and preds.shape == jpreds.shape
    for k, v in jper.items():
        np.testing.assert_allclose(per[k].numpy(), v, **STEP_TOL, err_msg=k)
    np.testing.assert_allclose(preds.numpy(), jpreds, rtol=1e-4, atol=1e-5)


# ----------------------------------------------------------- checkpoints
def _trainer_cfg(tmp_path, **kw):
    base = dict(STEP_KW, experiment="synthetic", log_dir=str(tmp_path),
                jobname="t", optimizer="adam", lr=1e-3, test_batch_size=2,
                niter=2, epoch_size=1, video_length=8, eval_interval=1,
                checkpoint_interval=1)
    base.update(kw)
    return base


def _jax_adam_state(js, jcfg):
    """optax adam state after one update of made-up gradients."""
    tx = jstep.make_optimizer(jcfg)
    grads = jax.tree_util.tree_map(lambda a: 0.1 * a + 0.01, js["params"])
    return jax.jit(lambda g, p: tx.update(g, tx.init(p), p)[1])(
        grads, js["params"])


def test_jax_checkpoint_loads_into_the_port(jax_side, tmp_path):
    """A JAX save_checkpoint file in the trainer's log dir: the port's
    trainer resumes from it (params, bn, adam state, step), and the loaded
    model's autoregressive eval window equals the JAX one (svg.step at
    every step) on the same trees."""
    js = jax_side
    kw = _trainer_cfg(tmp_path)
    jcfg = JConfig(**kw)
    state = _jax_adam_state(js, jcfg)
    trainer = PredictionTrainer(Config(**kw), device="cpu")
    jckpt.save_checkpoint(trainer.log_dir, 7, {"params": js["params"],
                                               "bn": js["bn"], "opt": state})
    trainer._resume()
    assert trainer._step == 7
    params, bn = convert.jax_flat_trees(trainer.model)
    for got, want in ((params, flat(js["params"])), (bn, flat(js["bn"]))):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    opt = convert.optimizer_to_jax(trainer.cfg, trainer.model, trainer.optimizer)
    want_opt = flat(state)
    assert set(opt) == set(want_opt)
    for k in want_opt:
        np.testing.assert_array_equal(opt[k], want_opt[k], err_msg=k)
    # the loaded model's steps against the JAX steps on the same trees
    _, jpreds = js["eval"][True]
    _, preds = tstep.make_eval_step(Config(**STEP_KW), trainer.model)(
        torch_batch(js["ebatch"]), noise=port_noise(3, True))
    np.testing.assert_allclose(preds.numpy(), jpreds, rtol=1e-4, atol=1e-5)


def test_port_checkpoint_loads_into_jax(jax_side, tmp_path):
    """A port checkpoint, after a train step with adam, loads through JAX
    load_checkpoint with JAX templates: every leaf equal, count 1."""
    js = jax_side
    kw = _trainer_cfg(tmp_path)
    jcfg = JConfig(**kw)
    trainer = PredictionTrainer(Config(**kw), device="cpu")
    trainer.train_step(torch_batch(js["batch"]), 1.0, trainer._generator)
    trainer._step = 1
    trainer._save(0)
    tckpt.wait_for_checkpoints()
    path = tckpt.latest_checkpoint(trainer.log_dir)
    assert path.endswith("ckpt_1.npz")
    templates = {"params": js["params"], "bn": js["bn"],
                 "opt": jstep.make_optimizer(jcfg).init(js["params"])}
    trees, step = jckpt.load_checkpoint(path, templates)
    assert step == 1
    want = trainer._trees()
    for name in ("params", "bn", "opt"):
        got = flat(trees[name])
        assert set(got) == set(want[name]), name
        for k in got:
            np.testing.assert_array_equal(got[k], want[name][k], err_msg=k)
    assert int(flat(trees["opt"])["[0].count"]) == 1
    assert np.abs(flat(trees["opt"])["[0].mu['frame_in']['w']"]).max() > 0


def test_checkpoint_rejects_a_missing_or_misshapen_leaf(tmp_path):
    path = tckpt.save_checkpoint(str(tmp_path), 3, {"params": {"['a']": np.zeros(2)}})
    assert tckpt.latest_checkpoint(str(tmp_path)) == path
    trees, step = tckpt.load_checkpoint(path, {"params": {"['a']": np.ones(2)}})
    assert step == 3 and np.array_equal(trees["params"]["['a']"], np.zeros(2))
    with pytest.raises(KeyError):
        tckpt.load_checkpoint(path, {"params": {"['b']": np.ones(2)}})
    with pytest.raises(ValueError):
        tckpt.load_checkpoint(path, {"params": {"['a']": np.ones(3)}})


def test_keystr_round_trip():
    key = "['encoder']['c1'][0]['conv']['w']"
    assert convert.parse_keystr(key) == ("encoder", "c1", "0", "conv", "w")
    assert convert.keystr(["encoder", "c1", 0, "conv", "w"]) == key
    with pytest.raises(ValueError):
        convert.parse_keystr("encoder.c1")


# ------------------------------------------------------------ data, CLI
def test_synthetic_data_equals_jax():
    """The same seed gives bit-identical arrays in both packages."""
    cfg = Config(action_dim=5, robot_dim=5, robot_joint_dim=5)
    want = jsynthetic_batch(JConfig(action_dim=5, robot_dim=5, robot_joint_dim=5),
                            3, 7, seed=4)
    got = synthetic_batch(cfg, 3, 7, seed=4)
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k]
    ds = SyntheticDataset(cfg.replace(video_length=5), 2, seed=1, num_batches=2)
    assert len(list(ds)) == 2


def test_argparser_takes_the_jax_flags():
    cfg, rest = argparser(["--experiment", "synthetic", "--remat", "true",
                           "--lr", "0.01", "--jobname", "x", "--wandb", "true"])
    assert cfg.experiment == "synthetic" and cfg.remat is True
    assert cfg.lr == 0.01 and cfg.jobname == "x" and rest == ["--wandb", "true"]
    with pytest.raises(ValueError, match="unknown flags"):
        main(["--device", "cpu", "--no_such_flag", "1"])


@pytest.mark.parametrize("kw", [dict(lstm_group_norm=True),
                                dict(model_use_heatmap=True),
                                dict(experiment="finetune_locobot"),
                                dict(model="det"),
                                dict(sharded_checkpoint=True)])
def test_unported_options_raise(tmp_path, kw):
    with pytest.raises(NotImplementedError):
        PredictionTrainer(Config(**_trainer_cfg(tmp_path, **kw)), device="cpu")


# --------------------------------------------------------------- trainer
TRAINER_KW = dict(g_dim=8, z_dim=2, image_height=16, image_width=16,
                  n_future=2, n_eval=3, video_length=6)
# the keys the JAX trainer logs for svg (trainer.py:540-555): the train
# step's metrics (JAX_TRAIN_KEYS, held against the JAX step in
# test_torch_port_train.py) and frames_per_sec under train/, the eval
# step's per-step metrics of both passes under eval/
JAX_EVAL_KEYS = {"recon_loss", "robot_loss", "world_loss", "psnr", "ssim", "kld"}


def test_trainer_trains_evaluates_saves_and_resumes(jax_side, tmp_path):
    """niter 2, epoch_size 1, 2 windows a video, eval every epoch: ckpt_*,
    metrics.jsonl and log.txt written; the logged keys are the JAX
    trainer's (its train and eval steps' keys); the loss is finite; a new
    trainer on the same dir resumes at the saved step."""
    assert set(jax_side["eval"][True][0]) == JAX_EVAL_KEYS
    cfg = Config(**_trainer_cfg(tmp_path, **TRAINER_KW))
    tr = PredictionTrainer(cfg, device="cpu")
    tr.train()
    tr.logger.close()
    files = os.listdir(tr.log_dir)
    assert {"metrics.jsonl", "log.txt", "ckpt_2.npz", "ckpt_4.npz"} <= set(files)
    with open(os.path.join(tr.log_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    train = [r for r in recs if "train/loss" in r]
    evals = [r for r in recs if any(k.startswith("eval/") for k in r)]
    assert len(train) == 2 and len(evals) == 2
    assert set(train[0]) - {"step", "wall_s"} == {
        f"train/{k}" for k in JAX_TRAIN_KEYS | {"frames_per_sec"}}
    assert set(evals[0]) - {"step", "wall_s"} == {
        f"eval/{t}{k}" for t in ("1step_", "autoreg_") for k in JAX_EVAL_KEYS}
    assert all(np.isfinite(r["train/loss"]) for r in train)
    with open(os.path.join(tr.log_dir, "log.txt")) as f:
        assert "saved checkpoint" in f.read()
    tr2 = PredictionTrainer(cfg, device="cpu")
    tr2._resume()
    assert tr2._step == tr._step == 4 and tr2._start_epoch == 2
    for k, v in tr.model.state_dict().items():
        torch.testing.assert_close(tr2.model.state_dict()[k], v, rtol=0, atol=0)
    tr2.logger.close()


@pytest.mark.parametrize("optimizer", ["adam", "rmsprop", "sgd"])
def test_trainer_checkpoint_round_trip(tmp_path, optimizer):
    """After a step, a port checkpoint restores the model, the BatchNorm
    statistics, the optimizer's state (none for sgd) and the step."""
    cfg = Config(**_trainer_cfg(tmp_path, optimizer=optimizer, **TRAINER_KW))
    tr = PredictionTrainer(cfg, device="cpu")
    batch = torch_batch(window(synthetic_batch(cfg, 2, 4, seed=0), 3))
    tr.train_step(batch, 1.0, tr._generator)
    tr._step = 1
    tr._save(0)
    tr2 = PredictionTrainer(cfg, device="cpu")
    tr2._resume()
    assert tr2._step == 1
    for k, v in tr.model.state_dict().items():
        torch.testing.assert_close(tr2.model.state_dict()[k], v, rtol=0, atol=0)
    for p, p2 in zip(tr.model.parameters(), tr2.model.parameters()):
        st, st2 = tr.optimizer.state.get(p, {}), tr2.optimizer.state.get(p2, {})
        assert set(st) == set(st2) == {"adam": {"step", "exp_avg", "exp_avg_sq"},
                                       "rmsprop": {"nu"}, "sgd": set()}[optimizer]
        for k in st:
            torch.testing.assert_close(st2[k], st[k], rtol=0, atol=0)
    tr.logger.close()
    tr2.logger.close()
