"""Checks of the port's plan serving on a GPU, shared by chip_smoke.py and
tests/test_torch_port_gpu.py. Imports neither JAX nor the JAX package.

  * `cell_invariance`: the ConvLSTM-cell kernels return, for a batch entry,
    bits that depend on its inputs alone: identical over repeated launches,
    whatever the launch's B and wherever the entry sits in the batch;
  * `plan_checks`: the same request planned again gives the same plan, and
    `get_action_batched` of R requests equals their single plans, bit for
    bit;
  * `serve_checks`: a PlanServer on a thread serves concurrent clients the
    plans the in-process planner gives, micro-batching them.
"""

from __future__ import annotations

import concurrent.futures as cf
import statistics
import time

import numpy as np
import torch

from robot_aware_control_tpu_torch.ops import kernels
from robot_aware_control_tpu_torch.utils.state import DemoGoalState, State

# the planner's cells: B = candidates x requests (1, 2, 4) and the trainer's
# eval batch, 6x8 maps of 256 + 256 channels (det's: 260 + 260), k = 5 and 3
CELL_BATCHES = (16, 100, 200, 400)
CELL_KS = (5, 3)
# where the rows of one request's B = 100 launch sit in a batched launch
OFFSETS = {200: (0, 100), 400: (0, 100, 200, 300)}


def cell_weights(k, dev, dtype=torch.bfloat16, Cx=256, C=256, seed=0):
    g = torch.Generator().manual_seed(seed)
    w = torch.randn(k, k, Cx + C, 4 * C, generator=g) * 0.02
    b = torch.randn(4 * C, generator=g) * 0.1
    return w.to(dev, dtype), b.to(dev)


def cell_rows(B, dev, dtype=torch.bfloat16, H=6, W=8, Cx=256, C=256, seed=1):
    """x, h, c of B rows; where a channel count is not a multiple of 8, as
    det holds them: views of buffers padded to one, NaN in the pad lanes."""
    g = torch.Generator().manual_seed(seed)
    out = []
    for n in (Cx, C, C):
        t = torch.randn(B, H, W, n, generator=g).to(dev, dtype)
        if n % 8:
            buf = torch.full((B, H, W, kernels.round_up(n)), float("nan"),
                             dtype=dtype, device=dev)
            t = buf[..., :n].copy_(t)
        out.append(t)
    return out


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def cell_invariance(dev, batches=CELL_BATCHES, ks=CELL_KS, repeats=50,
                    fn=None, channels=256, dtype=torch.bfloat16):
    """For each k: `repeats` launches of identical inputs at each B give
    identical bits; the rows of a B = 100 launch equal the same rows placed
    at offsets 0 and 100 of B = 200 launches and 0, 100, 200 and 300 of
    B = 400 launches whose other rows are different; and the first 16 rows
    equal a B = 16 launch of them; Cx = C = `channels` (det's 260: padded
    views, the layout det gives its cells), in `dtype`. Raises
    on the first difference. `fn` is the cell wrapper (default
    kernels.conv_lstm_cell, which must take the wgmma/TMA kernel at these
    shapes in bf16 and the float32 kernel in float32). Returns
    {"k=5": {...}, ...} with what was compared."""
    fn = fn or kernels.conv_lstm_cell
    out = {}
    C = channels
    for k in ks:
        w, b = cell_weights(k, dev, dtype, Cx=C, C=C)
        rows = cell_rows(max(batches), dev, dtype, Cx=C, C=C, seed=k)
        if (fn is kernels.conv_lstm_cell and dtype == torch.bfloat16
                and not all(kernels.tma_ready(t) for t in rows)):
            raise AssertionError("the planner's cell would be staged")
        ref = {}
        for B in batches:
            x, h, c = (t[:B] for t in rows)
            first = fn(x, h, c, w, b)
            for i in range(repeats - 1):
                if not _same(fn(x, h, c, w, b), first):
                    raise AssertionError(f"k={k} B={B}: launch {i + 2} of "
                                         "identical inputs differs")
            ref[B] = first
        base = cell_rows(100, dev, dtype, Cx=C, C=C, seed=10 + k)
        want = fn(*base, w, b)
        for B, offsets in OFFSETS.items():
            for o in offsets:
                big = cell_rows(B, dev, dtype, Cx=C, C=C, seed=20 + k + o + B)
                for t, r in zip(big, base):
                    t[o:o + 100] = r
                got = fn(*big, w, b)
                if not _same((t[o:o + 100] for t in got), want):
                    raise AssertionError(
                        f"k={k}: rows at offset {o} of B = {B} differ from "
                        "the same rows at B = 100")
        small = fn(*(t[:16] for t in base), w, b)
        if not _same(small, (t[:16] for t in want)):
            raise AssertionError(f"k={k}: B = 16 differs from the same rows "
                                 "at B = 100")
        out[f"k={k}"] = dict(repeats=repeats, batches=list(batches),
                             channels=C, dtype=str(dtype),
                             offsets={str(B): list(o)
                                      for B, o in OFFSETS.items()},
                             identical=True)
    return out


def small_cell_invariance(dev):
    """The same properties for the wgmma/TMA kernel at 13/20 channels (bf16,
    which the retired WMMA kernel took before: odd Cx; in padded views with NaN
    pad lanes, read in place, and on contiguous tensors, staged) and the
    float32 kernel of csrc/conv_lstm_cell_f32.cu, at small shapes: 10
    repeats, rows at offsets 0 and 5 of a launch of 3x the rows, every
    launch through the kernel of its type. Returns the checked paths."""
    done = []
    for dtype, Cx, C, layout in ((torch.bfloat16, 13, 20, "padded"),
                                 (torch.bfloat16, 13, 20, "contiguous"),
                                 (torch.float32, 16, 24, "padded")):
        counter = ("conv_lstm_cell_sm90" if dtype == torch.bfloat16
                   else "conv_lstm_cell_f32")

        def rows(B, seed):
            out = cell_rows(B, dev, dtype, Cx=Cx, C=C, seed=seed)
            return [t.contiguous() for t in out] if layout == "contiguous" else out

        for k in (5, 3):
            w, b = cell_weights(k, dev, dtype, Cx, C)
            base = rows(5, k)
            before = kernels.launches[counter]
            want = kernels.conv_lstm_cell(*base, w, b)
            for _ in range(9):
                if not _same(kernels.conv_lstm_cell(*base, w, b), want):
                    raise AssertionError(f"{dtype} {layout} k={k}: repeats differ")
            for o in (0, 5):
                big = rows(15, 30 + o)
                for t, r in zip(big, base):
                    t[o:o + 5] = r
                got = kernels.conv_lstm_cell(*big, w, b)
                if not _same((t[o:o + 5] for t in got), want):
                    raise AssertionError(f"{dtype} {layout} k={k}: offset {o} "
                                         "differs")
            if kernels.launches[counter] - before != 12:
                raise AssertionError(f"{dtype} {layout} k={k}: not every "
                                     f"launch took {counter}")
            done.append(f"{'sm90' if dtype == torch.bfloat16 else 'f32'} "
                        f"{layout} k={k}")
    return done


# ------------------------------------------------------------------ plans
def requests(R, h=48, w=64, seed=0, goal_states=False):
    """R distinct (start, goal, ep_num, step) requests made from a seed."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(R):
        start = State(img=rng.rand(h, w, 3).astype(np.float32),
                      state=np.array([0.3 + 0.02 * i, 0.01 * i, 0.15, 0, 0],
                                     np.float32),
                      qpos=np.zeros(5, np.float32))
        goal = DemoGoalState(
            imgs=[rng.rand(h, w, 3).astype(np.float32) for _ in range(2)],
            masks=[np.zeros((h, w), np.float32) for _ in range(2)],
            states=([rng.rand(5).astype(np.float32) for _ in range(2)]
                    if goal_states else None))
        out.append((start, goal, i, 2 * i + 1))
    return out


def plan_checks(policy, repeats=3, batch_sizes=(2, 3, 4)):
    """The same request planned `repeats` times gives one plan; for each R,
    get_action_batched of R distinct requests equals their single plans,
    bit for bit. Returns {"single": plan of request 0, "singles": [...],
    "batched": {R: max |batched - single|} (all 0)}."""
    reqs = requests(max(batch_sizes))
    singles = [policy.get_action(s, g, ep_num=e, step=t)
               for s, g, e, t in reqs]
    for i in range(repeats - 1):
        again = policy.get_action(*reqs[0][:2], ep_num=reqs[0][2],
                                  step=reqs[0][3])
        if not np.array_equal(again, singles[0]):
            raise AssertionError(f"plan {i + 2} of one request differs")
    diffs = {}
    for R in batch_sizes:
        got = policy.get_action_batched(
            [r[0] for r in reqs[:R]], [r[1] for r in reqs[:R]],
            ep_nums=[r[2] for r in reqs[:R]], steps=[r[3] for r in reqs[:R]])
        diffs[R] = max(float(np.abs(got[i] - singles[i]).max())
                       for i in range(R))
        for i in range(R):
            if not np.array_equal(got[i], singles[i]):
                raise AssertionError(f"R={R}: batched plan {i} differs from "
                                     f"its single plan by {diffs[R]}")
    return dict(single=singles[0], singles=singles, batched=diffs)


def serve_checks(server, singles, rounds=3, clients=4, h=48, w=64):
    """A started PlanServer: the first request twice through one client;
    then `rounds` rounds of one client alone and of `clients` concurrent
    clients sending distinct requests. Every served plan must equal
    `singles[i]` (request i planned in-process) and a batch of more than one
    request must be seen. Returns latencies (s), plans/s, the requests
    sent and the plan programs the server ran for them (a batch of any
    size is one)."""
    from robot_aware_control_tpu_torch.control.plan_server import PlanClient

    reqs = requests(clients, h=h, w=w)
    host, port = server.address
    conns = [PlanClient(host, port) for _ in range(clients)]
    try:
        for _ in range(2):
            plan = conns[0].plan(*reqs[0][:2], ep_num=reqs[0][2],
                                 step=reqs[0][3])
            if not np.array_equal(plan, singles[0]):
                raise AssertionError("served plan differs from local plan")
        one, many, rates, batched = [], [], [], []
        programs = 2 + rounds  # the requests of one client alone
        for _ in range(rounds):
            t0 = time.perf_counter()
            conns[0].plan(*reqs[0][:2], ep_num=reqs[0][2], step=reqs[0][3])
            one.append(time.perf_counter() - t0)

            def call(i):
                t = time.perf_counter()
                p = conns[i].plan(*reqs[i][:2], ep_num=reqs[i][2],
                                  step=reqs[i][3])
                return p, time.perf_counter() - t, conns[i].last_batched

            t0 = time.perf_counter()
            with cf.ThreadPoolExecutor(clients) as pool:
                res = list(pool.map(call, range(clients)))
            rates.append(clients / (time.perf_counter() - t0))
            for i, (p, dt, nb) in enumerate(res):
                if not np.array_equal(p, singles[i]):
                    raise AssertionError(f"client {i}: served plan differs "
                                         "from its local plan")
                many.append(dt)
                batched.append(nb)
            programs += round(sum(1 / r[2] for r in res))
        if max(batched) < 2:
            raise AssertionError(f"no request was batched: {batched}")
    finally:
        for c in conns:
            c.close()
    return dict(latency_1_client_s=statistics.median(one),
                latency_1_client_runs=one,
                latency_4_clients_s=statistics.median(many),
                latency_4_clients_runs=many,
                plans_per_s_4_clients=statistics.median(rates),
                plans_per_s_runs=rates, batched_seen=batched,
                requests=2 + rounds * (1 + clients), plan_programs=programs)
