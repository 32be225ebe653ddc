"""The port's finetune path held against the JAX trainer on the CPU: the
robot model's windows (the analytical locobot model, the learned robot
MLPs of a robot checkpoint, and heatmaps re-derived from the predicted
states), the finetune trainer on an HDF5 tree handing its steps the JAX
trainer's windows, the best-of-3 autoregressive eval with injected prior
noise, and --dynamics_model_ckpt loaded as a finetune through train()."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robot_aware_control_tpu.config import Config as JConfig
from robot_aware_control_tpu.models import robot_mlp as jmlp
from robot_aware_control_tpu.models import svg as jsvg
from robot_aware_control_tpu.training import checkpoint as jckpt
from robot_aware_control_tpu.training import step as jstep
from robot_aware_control_tpu.training.trainer import PredictionTrainer as JTrainer
from robot_aware_control_tpu_torch import convert
from robot_aware_control_tpu_torch.config import Config
from robot_aware_control_tpu_torch.data.loader import LOCOBOT_FOLDERS
from robot_aware_control_tpu_torch.data.norm import LOCOBOT_HIGH, LOCOBOT_LOW
from robot_aware_control_tpu_torch.training import checkpoint as tckpt
from robot_aware_control_tpu_torch.training.trainer import PredictionTrainer
from test_torch_port_data import (
    JAX_EVAL_KEYS,
    _recorder,
    _records,
    _write,
)
from torch_train_cases import (
    JAX_TRAIN_KEYS,
    STEP_KW,
    fixed_normal,
    flat,
    jax_trees,
    np_tree,
)
from torch_train_cases import one_torch_thread  # noqa: F401 (autouse)

# finetune_locobot at the small training config (24x32, g_dim 16, z_dim 4)
FT_KW = dict(STEP_KW, experiment="finetune_locobot", robot_joint_dim=5,
             model_use_mask=True, model_use_robot_state=True,
             reconstruction_loss="dontcare_l1", test_batch_size=2,
             optimizer="adam", lr=1e-3, niter=1, epoch_size=2, video_length=8,
             eval_interval=1, checkpoint_interval=1, data_threads=1,
             finetune_num_train=4, finetune_num_test=2)
STATE_TOL = 1e-6  # the IK's float32 arithmetic in another order


def _jax_trainer(jcfg, params=True):
    """The JAX trainer; with params False its model init is an empty tree
    (for recorder steps that read no parameters)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsvg, "init", jax.jit(jsvg.init, static_argnums=1)
                   if params else (lambda key, cfg: ({}, {})))
        return JTrainer(jcfg)


def _robot_ckpt(path):
    """A JAX {joint_model, gripper_model} checkpoint with weights unlike
    either package's init."""
    cfg = JConfig(**FT_KW)
    k = jax.random.split(jax.random.PRNGKey(11), 2)
    trees = {"joint_model": jmlp.joint_pos_predictor_init(k[0], cfg),
             "gripper_model": jmlp.gripper_state_predictor_init(k[1], cfg)}
    trees = jax.tree_util.tree_map(lambda a: a * 5.0, trees)
    return jckpt.save_checkpoint(str(path), 3, trees), trees


def _batch(rng, T=4, B=2):
    """A finetune host batch: frames, masks, normalized states, qpos,
    actions, the locobot bounds, robots and viewpoints."""
    return {"images": rng.rand(T, B, 24, 32, 3).astype(np.float32),
            "masks": (rng.rand(T, B, 24, 32, 1) > 0.8).astype(np.float32),
            "states": rng.uniform(0.3, 0.7, (T, B, 5)).astype(np.float32),
            "qpos": rng.uniform(-0.3, 0.3, (T, B, 5)).astype(np.float32),
            "actions": rng.uniform(-0.03, 0.03, (T - 1, B, 5)).astype(np.float32),
            "low": np.tile(LOCOBOT_LOW, (B, 1)), "high": np.tile(LOCOBOT_HIGH, (B, 1)),
            "robot": ["locobot"] * B, "folder": ["c0", "c2"][:B]}


APPLY_CASES = {"analytical": {}, "learned": dict(learned_robot_model=True),
               "heatmap": dict(model_use_heatmap=True)}


@pytest.mark.parametrize("case", sorted(APPLY_CASES))
def test_apply_robot_model_matches_jax(tmp_path, case, rng):
    """_apply_robot_model on one window: the predicted states to STATE_TOL
    (the learned MLPs' to 1e-5), the predicted masks (model input and
    pred_masks) bit for bit, the true masks kept, heatmaps from the
    predicted states to 1e-6. The learned case loads a JAX robot
    checkpoint through --robot_model_ckpt."""
    kw = dict(FT_KW, **APPLY_CASES[case], log_dir=str(tmp_path))
    if case == "learned":
        kw["robot_model_ckpt"], trees = _robot_ckpt(tmp_path / "robot")
    jtr = _jax_trainer(JConfig(**dict(kw, num_devices=1)), params=False)
    tr = PredictionTrainer(Config(**kw), device="cpu")
    assert (tr.learned_robot is None) == (case != "learned")
    assert (tr.robot_model is None) == (case == "learned")
    if case == "learned":
        np.testing.assert_array_equal(
            tr.learned_robot["joint"].l3.weight.numpy(),
            np.asarray(trees["joint_model"]["l3"]["w"]).T)
    batch = _batch(rng)
    window = {k: batch[k] for k in ("images", "masks", "states", "qpos", "actions")}
    want = jtr._apply_robot_model(dict(window), batch)
    tbatch = {k: torch.tensor(v) if isinstance(v, np.ndarray) else v
              for k, v in batch.items()}
    got = tr._apply_robot_model({k: tbatch[k] for k in window}, tbatch)
    assert set(got) == set(want)
    np.testing.assert_allclose(got["states"].numpy(), np.asarray(want["states"]),
                               atol=1e-5 if case == "learned" else STATE_TOL)
    for k in ("pred_masks", "masks_model_input", "masks", "images"):
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=k)
    assert 0 < np.asarray(want["pred_masks"]).mean() < 1
    if case == "heatmap":
        np.testing.assert_allclose(got["heatmaps"].numpy(), want["heatmaps"],
                                   atol=1e-6)
        assert want["heatmaps"].max() > 0.1
    jtr.logger.close()
    tr.logger.close()


@pytest.fixture(scope="module")
def locobot_tree(tmp_path_factory):
    """Locobot views c0-c3, 2 files each: 8-frame 24x32 episodes, states
    inside the locobot workspace (the reader applies the locobot bounds)."""
    root = tmp_path_factory.mktemp("ft")
    n = 0
    for view in LOCOBOT_FOLDERS:
        for i in range(2):
            n += 1
            _write(root / "locobot_views" / view / f"t{i}.hdf5", 100 + n, T=8,
                   hw=(24, 32))
    return root


def _close(got, want, where):
    """Windows of the two trainers: every key equal bit for bit but the
    predicted states (to 1e-5: the IK's or the MLPs' float32 sums)."""
    assert set(got) == set(want), where
    for k in want:
        if k == "states":
            np.testing.assert_allclose(got[k], want[k], atol=1e-5, err_msg=where)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{where} {k}")


@pytest.mark.parametrize("robot", ["analytical", "learned"])
def test_finetune_trainer_hands_its_steps_the_jax_windows(locobot_tree, tmp_path,
                                                          robot):
    """finetune_locobot on an HDF5 tree (one loader thread each, niter 1, 2
    batches of 2 videos, the few-shot split): the port's train steps are
    handed the JAX trainer's windows, with the robot model's states and
    masks in place of the data's, in the same order with the same
    scheduled-sampling probability; its eval steps the same windows (true
    masks and pred_masks, then the gif's rollout on the true masks), 3 a
    window in the autoregressive pass (best of 3 for svg); both log the
    same keys at the same steps. The JAX steps are recorders (nothing of
    the JAX model compiles); the port's its real steps, recorded."""
    kw = dict(FT_KW, data_root=str(locobot_tree))
    if robot == "learned":
        kw.update(learned_robot_model=True,
                  robot_model_ckpt=_robot_ckpt(tmp_path / "robot")[0])
    rec = {"jax": {"train": [], "eval": []}, "port": {"train": [], "eval": []}}
    jtr = _jax_trainer(JConfig(**dict(kw, log_dir=str(tmp_path / "jax"),
                                      num_devices=1, async_checkpoint=False)),
                       params=False)
    jtr.train_step = _recorder(rec["jax"]["train"], metrics=JAX_TRAIN_KEYS)
    jtr.eval_step_ar = jtr.eval_step_1 = _recorder(
        rec["jax"]["eval"], metrics=JAX_EVAL_KEYS, preds=True)
    jtr.train()
    jtr.logger.close()
    tr = PredictionTrainer(Config(**dict(kw, log_dir=str(tmp_path / "port"))),
                           device="cpu")
    tr.train_step = _recorder(rec["port"]["train"], step=tr.train_step)
    tr.eval_step_ar = _recorder(rec["port"]["eval"], step=tr.eval_step_ar)
    tr.eval_step_1 = _recorder(rec["port"]["eval"], step=tr.eval_step_1)
    tr.train()
    tr.logger.close()
    for kind in ("train", "eval"):
        want, got = rec["jax"][kind], rec["port"][kind]
        assert len(got) == len(want) > 0, kind
        for n, (g, w) in enumerate(zip(got, want)):
            _close(g[0], w[0], f"{kind} window {n}")
            assert g[1:] == w[1:], f"{kind} window {n}"
    train = rec["port"]["train"]
    assert len(train) == 2 * 2 and "qpos" not in train[0][0]
    # the model input is the robot model's masks, not the data's
    assert {"pred_masks", "masks", "states"} <= set(rec["port"]["eval"][0][0])
    # per test batch (one: 2 test files) 1-step (1 a window) then
    # autoregressive (3 a window), then the gif's rollout
    windows = FT_KW["video_length"] // FT_KW["n_eval"]
    assert len(rec["port"]["eval"]) == windows * (1 + 3) + 1
    assert _records(os.path.join(tr.log_dir, "metrics.jsonl")) == _records(
        os.path.join(jtr.log_dir, "metrics.jsonl"))


def _scaled_noise(n):
    return fixed_normal if n == 0 else (lambda shape: fixed_normal(shape) * (
        1.0 + 0.6 * n))


def test_best_of_3_eval_matches_jax(tmp_path, monkeypatch, rng):
    """An svg finetune's autoregressive eval of a video (2 windows): 3
    prior samples a window with injected noise (the fixed stand-in scaled
    by 1, 1.6 and 2.2, sample by sample in both packages), the sample with
    the best PSNR kept; its metrics to 1e-4 relative. The 1-step pass takes
    one sample."""
    kw = dict(FT_KW, log_dir=str(tmp_path), n_eval=3)
    jcfg = JConfig(**dict(kw, num_devices=1))
    params, bn = jax_trees(jcfg)
    jtr = _jax_trainer(jcfg, params=False)
    jtr.params, jtr.bn = params, bn
    calls = {"jax": 0, "port": 0}
    jsteps = [jstep.make_eval_step(jcfg, autoregressive=True) for _ in range(3)]

    def jax_eval(p, b, window, key):
        n = calls["jax"] % 3
        calls["jax"] += 1
        with monkeypatch.context() as mp:
            mp.setattr(jax.random, "normal", lambda key, shape=(), dtype=jnp.float32:
                       jnp.asarray(_scaled_noise(n)(tuple(shape)), dtype))
            return jsteps[n](p, b, window, key)

    jtr.eval_step_ar = jax_eval
    tr = PredictionTrainer(Config(**kw), device="cpu")
    tr.model.load_state_dict(convert.svg_state_dict(np_tree(params), np_tree(bn)))
    port_eval = tr.eval_step_ar

    def port_ar(window, generator=None):
        n = calls["port"] % 3
        calls["port"] += 1
        B = window["images"].shape[1]
        eps = torch.tensor(_scaled_noise(n)((2, B, 3, 4, 4)))
        return port_eval(window, noise={"use_truth": torch.ones(2, dtype=torch.bool),
                                        "eps_prior": eps, "eps_post": eps})

    tr.eval_step_ar = port_ar
    batch = _batch(rng, T=6)
    want = jtr._eval_video(batch, autoregressive=True)
    tbatch = {k: torch.tensor(v) if isinstance(v, np.ndarray) else v
              for k, v in batch.items()}
    got = tr._eval_video(tbatch, autoregressive=True)
    assert calls == {"jax": 6, "port": 6}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    jtr.logger.close()
    tr.logger.close()


def test_dynamics_model_ckpt_is_a_finetune_in_train(locobot_tree, tmp_path):
    """--dynamics_model_ckpt with a finetune experiment, through train():
    both trainers start training at step 0 with the checkpoint's parameters
    and BatchNorm statistics and a fresh optimizer (optax's init; the
    port's Adam without state), though the file holds a step and moments."""
    kw = dict(FT_KW, data_root=str(locobot_tree))
    jcfg = JConfig(**dict(kw, log_dir=str(tmp_path / "jax"), num_devices=1))
    params, bn = jax_trees(jcfg)
    params = jax.tree_util.tree_map(lambda a: a + 0.01, params)
    opt = jstep.make_optimizer(jcfg)
    state = jax.jit(lambda g, p: opt.update(g, opt.init(p), p)[1])(
        jax.tree_util.tree_map(lambda a: 0.1 * a, params), params)
    path = jckpt.save_checkpoint(str(tmp_path / "src"), 7,
                                 {"params": params, "bn": bn, "opt": state})
    kw["dynamics_model_ckpt"] = path
    seen = {}

    class Started(Exception):
        pass

    jtr = _jax_trainer(JConfig(**dict(kw, log_dir=str(tmp_path / "jax"),
                                      num_devices=1)))

    def jax_resume():
        seen["jax"] = (jtr._step, flat(jtr.params), flat(jtr.bn), flat(jtr.opt_state))
        raise Started

    jtr._resume = jax_resume
    with pytest.raises(Started):
        jtr.train()
    jtr.logger.close()
    tr = PredictionTrainer(Config(**dict(kw, log_dir=str(tmp_path / "port"))),
                           device="cpu")

    def port_epochs(train_iter, test_loader):
        params_, bn_ = convert.jax_flat_trees(tr.model)
        seen["port"] = (tr._step, params_, bn_, dict(tr.optimizer.state))

    tr._train_epochs = port_epochs
    tr.train()
    tr.logger.close()
    jstep_, jparams, jbn, jopt = seen["jax"]
    step, tparams, tbn, topt = seen["port"]
    assert step == jstep_ == 0
    assert topt == {}
    assert int(jopt["[0].count"]) == 0
    assert all(not v.any() for k, v in jopt.items() if k != "[0].count")
    for got, want, ref in ((tparams, jparams, flat(params)), (tbn, jbn, flat(bn))):
        assert set(got) == set(want) == set(ref)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    # the port's checkpoint after train() is at step 0, not the file's 7
    assert tckpt.latest_checkpoint(tr.log_dir).endswith("ckpt_0.npz")
