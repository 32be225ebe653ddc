"""The port's int8 planning (ops/quant.py) held against the JAX package on
the CPU: the quantized weights bit for bit (svg and det weights carried
over by convert.py), the int8 conv against JAX `_conv2d_int8`, the GEMM
route of the GPU against the plain version, the rollout's drift, an int8
CEM plan against JAX's with injected noise, and the scope of the
activation scale: per request in batched and served plans, per chunk of
candidates, not split by the convolutions' row split."""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robot_aware_control_tpu.config import Config as JConfig
from robot_aware_control_tpu.models.registry import get_model as jget_model
from robot_aware_control_tpu.ops import nn as jnn
from robot_aware_control_tpu.ops import quant as jquant
from robot_aware_control_tpu.planning import cem as jcem
from robot_aware_control_tpu_torch import convert
from robot_aware_control_tpu_torch.config import Config
from robot_aware_control_tpu_torch.control.plan_server import PlanServer
from robot_aware_control_tpu_torch.data.norm import LOCOBOT_HIGH, LOCOBOT_LOW, normalize
from robot_aware_control_tpu_torch.models import svg, svg_vector
from robot_aware_control_tpu_torch.ops import quant
from robot_aware_control_tpu_torch.ops.lstm import ConvLSTMCell
from robot_aware_control_tpu_torch.ops.nn import Conv2d, ConvTranspose, Linear, conv_rows
from robot_aware_control_tpu_torch.planning import rollout as trollout
from robot_aware_control_tpu_torch.planning.cem import CEMPolicy
from robot_aware_control_tpu_torch.planning.rollout import (
    RolloutEngine,
    prepare_goals,
    request_inputs,
)
from test_torch_port_planning import _start_goal
from torch_serve_cases import requests, serve_checks
from torch_train_cases import one_torch_thread, random_tree  # noqa: F401

# the planning config of the JAX int8 tests (tests/test_quant.py:quant_cfg)
QUANT_KW = dict(
    model="svg", g_dim=16, z_dim=4, image_width=64, image_height=48,
    action_dim=5, robot_dim=5, robot_joint_dim=5, model_use_mask=True,
    model_use_robot_state=True, reconstruction_loss="dontcare_l1",
    reward_type="dontcare", compute_dtype="float32", horizon=3,
    opt_iter=2, action_candidates=8, topk=3, cem_init_std=0.015,
    plan_quantize="int8",
)


# the port-only scale-scope cases: the same model at 24x32 frames, 4
# candidates, one iteration (a quarter of the float64 int8 convolutions)
SMALL_KW = dict(QUANT_KW, image_height=24, image_width=32, opt_iter=1,
                action_candidates=4, topk=2)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def families():
    """{family: (jcfg, params, bn, cfg, float port model)} for svg and det:
    the JAX init's shapes filled from a seed at the reference's scale
    (tests/torch_train_cases.py:random_tree; jit-compiling the inits
    would take longer than the tests)."""
    out = {}
    r = np.random.RandomState(1)
    for fam in ("svg", "det"):
        kw = dict(QUANT_KW, model=fam, sample_mean=True)
        jcfg = JConfig(**kw)
        init = jget_model(jcfg).init
        shapes = jax.eval_shape(lambda: init(jax.random.PRNGKey(0), jcfg))
        params, bn = random_tree(shapes, r, he=False)
        cfg = Config(**kw)
        model = convert.model_from_jax(cfg, params, bn, device="cpu")
        out[fam] = (jcfg, params, bn, cfg, model)
    return out


# the JAX int8 plan's config: one iteration, the 8 candidates in 2 chunks
CHUNKED = dict(candidates_batch_size=4, opt_iter=1)


@pytest.fixture(scope="module")
def jax_int8_policy(families):
    """The JAX int8 CEMPolicy of svg (its params quantized op by op at
    construction, as the JAX planner does), traced at its first plan."""
    jcfg, params, bn, _, _ = families["svg"]
    return jcem.CEMPolicy(jcfg.replace(**CHUNKED),
                          jax.tree_util.tree_map(jnp.asarray, params), bn)


def _node(tree, path):
    for p in path:
        tree = tree[p]
    return tree


@pytest.mark.parametrize("family", ["svg", "det"])
def test_quantized_weights_equal_jax(families, jax_int8_policy, family):
    """Every conv's and conv cell's w_q and w_scale equal JAX
    quantize_conv_tree's bit for bit, and there are as many of them."""
    _, params, _, _, model = families[family]
    # op by op, as the JAX policy quantizes (under jit XLA divides by 127
    # as a product with its reciprocal: 3 of 64 scales differ by an ulp);
    # svg's tree is the JAX int8 policy's own
    jq = (jax_int8_policy.params if family == "svg" else
          jquant.quantize_conv_tree(jax.tree_util.tree_map(jnp.asarray, params)))
    qmodel = quant.quantize_model(model)
    n = 0
    for name, m in model.named_modules():
        if isinstance(m, (Conv2d, ConvLSTMCell)):
            path = convert._jax_leaf(model, name + ".weight")[1][:-1]
            want = _node(jq, path)
            got = qmodel.get_submodule(name)
            if isinstance(m, ConvLSTMCell):
                got = got.gates
            w_q = got.w_q.permute(2, 3, 1, 0).numpy()  # OIHW -> HWIO
            np.testing.assert_array_equal(w_q, np.asarray(want["w_q"]), name)
            np.testing.assert_array_equal(got.w_scale.numpy(),
                                          np.asarray(want["w_scale"]), name)
            n += 1
    count = sum(1 for leaf in jax.tree_util.tree_leaves_with_path(jq)
                if jax.tree_util.keystr(leaf[0]).endswith("['w_q']"))
    assert n == count > 0


def test_quantize_model_is_a_new_model_and_idempotent(families):
    """The caller's float model stays float; quantizing the int8 model
    again hands it back; every GEMM weight is row-major; transpose convs,
    Linear layers and BatchNorm stay float (svg_vec's upc1)."""
    _, _, _, cfg, model = families["svg"]
    before = {k: v.clone() for k, v in model.state_dict().items()}
    q = quant.quantize_model(model)
    assert q is not model and quant.quantize_model(q) is q
    assert any(isinstance(m, Conv2d) for m in model.modules())
    assert not any(isinstance(m, (Conv2d, ConvLSTMCell)) for m in q.modules())
    # the GEMM's weights row-major: the cells' too, quantized from (k, k,
    # I, O) (column-major, they took a slow int8 kernel on the card)
    gemm = [m.w_mat for m in q.modules() if isinstance(m, quant.Int8Conv2d)]
    assert len(gemm) > 6 and all(w.is_contiguous() for w in gemm)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    vec = svg_vector.SVGVec(Config(**dict(QUANT_KW, model="svg_vec",
                                          image_height=16, image_width=32)),
                            device="cpu")
    qv = quant.quantize_model(vec)
    assert any(isinstance(m, ConvTranspose) for m in qv.modules())
    assert any(isinstance(m, Linear) for m in qv.modules())
    assert any(isinstance(m, quant.Int8Conv2d) for m in qv.modules())
    assert quant.maybe_quantize_plan_model(cfg.replace(plan_quantize="none"),
                                           model) is model


def test_plan_quantize_values():
    assert Config(plan_quantize="int8").plan_quantize == "int8"
    with pytest.raises(ValueError, match="plan_quantize"):
        Config(plan_quantize="int4")


CONV_CASES = {  # (k, stride, cin, cout, bias)
    "k3": (3, 1, 8, 16, True),
    "k5_no_bias": (5, 1, 12, 8, False),
    "k3_stride2": (3, 2, 8, 16, True),
    "k1_odd": (1, 1, 5, 7, True),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_int8_conv_equals_jax(rng, case):
    """The port's int8 conv against JAX `_conv2d_int8` on the same inputs,
    in float32: bit for bit (XLA's and torch's quotient x / s_x round
    alike here; no element differs)."""
    k, stride, cin, cout, bias = CONV_CASES[case]
    w = (rng.randn(k, k, cin, cout) * 0.2).astype(np.float32)
    b = rng.randn(cout).astype(np.float32)
    x = (rng.randn(3, 10, 12, cin) * 1.7).astype(np.float32)
    p = {"w": jnp.asarray(w)}
    if bias:
        p["b"] = jnp.asarray(b)
    want = np.asarray(jnn.conv2d(jquant.quantize_conv_params(p),
                                 jnp.asarray(x), stride=stride))
    conv = quant.Int8Conv2d(torch.tensor(w).permute(3, 2, 0, 1),
                            torch.tensor(b) if bias else None, stride=stride)
    got = conv(torch.tensor(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(2, 6, 8, 24, 32, 5, 1),
                                   (1, 3, 4, 5, 7, 3, 1),
                                   (2, 7, 9, 6, 16, 3, 2)])
def test_gemm_route_equals_plain(rng, shape):
    """The GPU's route (im2col of the int8 activation, torch._int_mm, which
    also runs on this CPU) gives the plain float64 version's int32 sums:
    K and N not multiples of 8, M under 16 rows, a stride of 2."""
    B, H, W, C, O, k, stride = shape
    x_q = torch.tensor(rng.randint(-127, 128, (B, H, W, C)), dtype=torch.int8)
    w_q = torch.tensor(rng.randint(-127, 128, (O, C, k, k)), dtype=torch.int8)
    pads = quant._pads(x_q.shape, (k, k), stride, "same")
    want = quant.conv_int8_plain(x_q, w_q, stride, pads)
    before = quant.launches["int8_mm"]
    got = quant.conv_int8_mm(x_q, quant.gemm_weight(w_q), O, (k, k), stride,
                             pads)
    assert quant.launches["int8_mm"] == before + 1
    assert got.dtype == torch.int32
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_row_split_does_not_split_the_scale(rng):
    """conv_rows (each request's rows apart) leaves an int8 conv's scale
    whole; amax_rows splits it."""
    conv = quant.Int8Conv2d(torch.randn(8, 4, 3, 3), torch.zeros(8))
    x = torch.tensor(rng.randn(4, 6, 6, 4).astype(np.float32))
    x[:2] *= 10.0  # rows 0-1 and 2-3 would take other scales apart
    whole = conv(x)
    with conv_rows(2):
        assert torch.equal(conv(x), whole)
    with quant.amax_rows(2):
        apart = conv(x)
    assert not torch.equal(apart, whole)
    torch.testing.assert_close(apart[2:], conv(x[2:]), rtol=0, atol=0)


def _rollout(cfg, model, start, goal, acts, ret_obs=False):
    gi, gm, gs = prepare_goals(goal, acts.shape[1])
    s_norm = normalize(start.state, LOCOBOT_LOW, LOCOBOT_HIGH)
    return RolloutEngine(cfg, device="cpu")(
        model, torch.tensor(start.img), torch.tensor(s_norm),
        torch.tensor(start.qpos), torch.tensor(acts), torch.tensor(gi),
        torch.tensor(gm), torch.Generator().manual_seed(0), ret_obs=ret_obs)


@pytest.mark.parametrize("family", ["svg", "det"])
def test_rollout_drift_bounded(families, rng, family):
    """A 5-step int8 rollout stays within 0.05 of the float rollout on
    frames in [0, 1] (JAX's own bound, tests/test_quant.py), for svg and
    det."""
    _, _, _, cfg, model = families[family]
    start, goal = _start_goal(rng)
    acts = rng.uniform(-0.05, 0.05, (2, 5, 5)).astype(np.float32)
    _, f32 = _rollout(cfg, model, start, goal, acts, ret_obs=True)
    _, q8 = _rollout(cfg, quant.quantize_model(model), start, goal, acts,
                     ret_obs=True)
    drift = float((f32 - q8).abs().max())
    assert 0 < drift < 0.05, drift


def test_int8_plan_matches_jax(families, jax_int8_policy, rng, monkeypatch):
    """An int8 CEM plan with injected action noise gives the JAX int8 plan
    within 1e-5. candidates_batch_size 4 runs the 8 candidates in two
    chunks, each taking its own activation scales, as JAX's lax.map runs
    each chunk's convs apart (cem.py:149-157)."""
    _, _, _, cfg, model = families["svg"]
    cfg = cfg.replace(**CHUNKED)
    start, goal = _start_goal(rng)
    noise = rng.randn(8, 2, 2).astype(np.float32)
    normal = jax.random.normal

    def fake(key, shape=(), dtype=jnp.float32):
        if tuple(shape) == noise.shape:
            return jnp.asarray(noise, dtype)
        return normal(key, shape, dtype)

    monkeypatch.setattr(jax.random, "normal", fake)
    want = np.asarray(jax_int8_policy.get_action(start, goal))
    policy = CEMPolicy(cfg, model, device="cpu")
    assert policy.model is not model
    got = policy.get_action(start, goal, noise=noise[None])
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.fixture(scope="module")
def small():
    """(cfg, float model, int8 policy) at SMALL_KW, weights from a seed,
    the convolutions He-scaled (at N(0, 0.02) the prediction hardly
    depends on its inputs, nor on their scales)."""
    cfg = Config(**SMALL_KW)
    model = svg.init(cfg, seed=3, device="cpu")
    g = torch.Generator().manual_seed(4)
    for m in model.modules():
        if isinstance(m, (Conv2d, ConvLSTMCell)):
            w = m.weight
            fan_in = w[0].numel() if isinstance(m, Conv2d) else w[..., 0].numel()
            w.copy_(torch.randn(w.shape, generator=g) * (2.0 / fan_in) ** 0.5)
    return cfg, model, CEMPolicy(cfg, model, device="cpu")


def _batched_and_singles(policy, R=3):
    reqs = requests(R, h=24, w=32)
    singles = [policy.get_action(s, g, ep_num=e, step=t)
               for s, g, e, t in reqs]
    got = policy.get_action_batched([r[0] for r in reqs], [r[1] for r in reqs],
                                    ep_nums=[r[2] for r in reqs],
                                    steps=[r[3] for r in reqs])
    return got, singles


def test_int8_batched_plan_equals_single_plans(small):
    """R = 3 requests (padded to 4) planned together: each plan is its
    single plan bit for bit, as the JAX package's vmap takes each
    request's scale apart."""
    got, singles = _batched_and_singles(small[2])
    for i, s in enumerate(singles):
        np.testing.assert_array_equal(got[i], s)


def _engine_costs(cfg, model, reqs, n=4):
    """The rollout costs of `reqs` planned together (R x n candidates) and
    of each alone, for the same actions (the prior's mean: no draws)."""
    engine = RolloutEngine(cfg.replace(sample_mean=True), device="cpu")
    rng = np.random.RandomState(5)
    acts = rng.uniform(-0.05, 0.05, (len(reqs), n, 2, 5)).astype(np.float32)
    inputs = [[torch.tensor(a) for a in request_inputs(cfg, s, g, 2)[:5]]
              for s, g, _, _ in reqs]
    run = lambda ins, a: engine(model, *ins[:3], torch.tensor(a), *ins[3:])
    together = run([torch.stack(t) for t in zip(*inputs)],
                   acts.reshape(-1, 2, 5)).view(len(reqs), n)
    return together, [run(i, a) for i, a in zip(inputs, acts)]


def _rel(together, alone):
    return max(float(((together[r] - a).abs() / a.abs()).max())
               for r, a in enumerate(alone))


def test_int8_scale_is_per_request(small, monkeypatch):
    """A dark and a bright request rolled out together give each one's
    costs alone, bit for bit; with the scale taken over the stacked batch
    (the per-request scope off) the dark request quantizes on the bright
    one's scale and its costs move."""
    cfg, model, policy = small
    reqs = requests(2, h=24, w=32)
    dark = dataclasses.replace(reqs[1][0], img=reqs[1][0].img * 0.1)
    reqs[1] = (dark,) + reqs[1][1:]
    assert _rel(*_engine_costs(cfg, policy.model, reqs)) == 0
    monkeypatch.setattr(trollout.quant, "amax_rows",
                        lambda rows: contextlib.nullcontext())
    assert _rel(*_engine_costs(cfg, policy.model, reqs)) > 1e-4


def test_served_int8_plans_equal_local_plans(small):
    """Plans served by PlanServer under int8, micro-batched or alone, equal
    the local plans bit for bit."""
    cfg, model, policy = small
    singles = [policy.get_action(s, g, ep_num=e, step=t)
               for s, g, e, t in requests(3, h=24, w=32)]
    server = PlanServer(cfg, model, device="cpu")
    assert server.info()["plan_quantize"] == "int8"
    thread = server.start()
    try:
        serve_checks(server, singles, rounds=1, clients=3, h=24, w=32)
    finally:
        server.close()
        thread.join(timeout=10)
