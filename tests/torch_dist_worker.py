"""Rank processes of the port's multi-process CPU tests.

``run_ranks(case, inputs, workdir)`` writes ``inputs`` to
``workdir/inputs.pt`` and starts ``torchrun --standalone --nproc_per_node
N`` on this file (two torch threads a rank at most); each rank joins
the gloo group
(``parallel.mesh.initialize_distributed(device="cpu")``), runs
``CASES[case]`` and writes ``workdir/rank{r}.pt``, which ``run_ranks``
returns in rank order. The ranks import torch and the port only (no JAX):
the test process computes the JAX side and compares.

    torchrun --standalone --nproc_per_node 2 tests/torch_dist_worker.py CASE DIR
"""

import contextlib
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_ranks(case, inputs, workdir, nproc=2, timeout=240):
    """Run ``case`` on ``nproc`` gloo ranks; their outputs in rank order."""
    return start_ranks(case, inputs, workdir, nproc, timeout)()


def start_ranks(case, inputs, workdir, nproc=2, timeout=240):
    """Start ``case`` on ``nproc`` gloo ranks and return at once a function
    that waits for them and returns their outputs in rank order (the
    caller works meanwhile)."""
    workdir = str(workdir)
    os.makedirs(workdir, exist_ok=True)
    torch.save(inputs, os.path.join(workdir, "inputs.pt"))
    # two threads a rank, fewer where the caller has fewer (an xdist
    # worker's share of the cores, tests/torch_threads.py)
    threads = str(min(2, torch.get_num_threads()))
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS=threads)
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(nproc), os.path.abspath(__file__), case,
         workdir],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)

    def wait():
        try:
            out, err = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise
        assert proc.returncode == 0, out[-4000:] + err[-8000:]
        return [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                           weights_only=False) for r in range(nproc)]

    return wait


# ---------------------------------------------------------------- cases

def case_ops(inp):
    """The sharded ops on this rank's rows, the shard context, the
    collectives' gradients and the batch split."""
    import numpy as np

    from tpugan_tpu_torch.ops.neighbors import gather, graph_knn, point_shard_axis
    from tpugan_tpu_torch.parallel import mesh
    from tpugan_tpu_torch.parallel.sharded_ops import (sharded_ball_query,
                                                       sharded_chamfer,
                                                       sharded_knn)

    world, r = mesh.world_size(), mesh.rank()
    q, c = inp["q"], inp["c"]
    rows = mesh.rows_of(q.shape[1], world, r)
    ql, cl = q[:, rows], c[:, rows]
    out = {"knn": sharded_knn(ql, cl, inp["k"]),
           "ball": sharded_ball_query(ql, cl, inp["radius"], inp["nsample"]),
           "chamfer": sharded_chamfer(ql, cl)}
    with point_shard_axis(mesh.DATA_AXIS):
        d2, idx = graph_knn(ql, inp["k"])
        out["graph_knn"] = (d2, idx)
        out["gather"] = gather(cl, idx.reshape(idx.shape[0], -1))
    out["outside"] = graph_knn(ql, inp["k"])

    xrows = mesh.rows_of(inp["x"].shape[0], world, r)
    x = inp["x"][xrows].clone().requires_grad_()
    (mesh.all_gather(x, 0) * inp["coef_gather"][r]).sum().backward()
    out["grad_gather"] = x.grad
    x = inp["x"][xrows].clone().requires_grad_()
    (mesh.all_reduce(x) * inp["coef_reduce"][r][xrows]).sum().backward()
    out["grad_reduce"] = x.grad
    out["average"] = mesh.average_gradients({"a": inp["grads"][r], "b": None})
    out["batch"] = mesh.batch_sharded({"x": inp["batch"], "h": np.float32(1)})
    try:
        mesh.batch_sharded({"x": np.zeros((3, 3, 2), np.float32)})
        out["uneven"] = "accepted"
    except ValueError as e:
        out["uneven"] = str(e)
    return out


def _srnet(inp):
    from tpugan_tpu_torch.models.generator import SRNet

    model = SRNet(device="cpu", **inp["srnet"])
    model.load_state_dict(inp["state_dict"])
    return model


def case_serving(inp):
    """The sharded rollout (pipelined and serial), the graph lists it
    built (each with the gathered cloud and valid mask it searched), the
    rollout CLI with ``--shard_points``, and the pipelined rollout and
    graph lists of the dynamic-graph model ``inp["dynamic"]``."""
    import tpugan_tpu_torch.models.generator as generator_mod
    import tpugan_tpu_torch.nn.edgeconv as edgeconv_mod
    from tpugan_tpu_torch.cli import rollout as rollout_cli
    from tpugan_tpu_torch.ops.neighbors import _gather_points, graph_knn
    from tpugan_tpu_torch.parallel.sharded_serving import \
        rollout_sequence_sharded

    graphs = []

    def recording(x, k, c_valid=None):
        d2, idx = graph_knn(x, k, c_valid)
        graphs.append((_gather_points(x), idx, None if c_valid is None
                       else _gather_points(c_valid)))
        return d2, idx

    def recorded(model, **kw):
        del graphs[:]
        generator_mod.graph_knn = edgeconv_mod.graph_knn = recording
        try:
            return rollout_sequence_sharded(model, inp["pos"], inp["vel"],
                                            max_pending=4, **kw), list(graphs)
        finally:
            generator_mod.graph_knn = edgeconv_mod.graph_knn = graph_knn

    model = _srnet(inp)
    kw = dict(use_vel=True, history=inp["history"])
    piped, static = recorded(model, **kw)
    serial = rollout_sequence_sharded(model, inp["pos"], inp["vel"],
                                      max_pending=0, **kw)
    cli = rollout_cli.main(inp["cli_args"])
    dynamic, dynamic_graphs = recorded(_srnet(inp["dynamic"]), **kw)
    return {"piped": piped, "serial": serial, "graphs": static, "cli": cli,
            "dynamic": dynamic, "dynamic_graphs": dynamic_graphs}


def _pooled_counter():
    """Counts the calls of the pooled-MLP batch-norm kernel's entry."""
    import tpugan_tpu_torch.nn.layers as layers

    calls = [0]
    own = layers.pooled_mlp_bn_train

    def counted(*a, **k):
        calls[0] += 1
        return own(*a, **k)

    layers.pooled_mlp_bn_train = counted
    return calls


def _collective_counter():
    """Counts the collectives the port's ``parallel.mesh`` makes (every
    all-reduce, autograd-aware or not, and every gather)."""
    from tpugan_tpu_torch.parallel import mesh

    calls = [0]

    def counted(fn):
        def run(*a, **k):
            calls[0] += 1
            return fn(*a, **k)
        return run

    mesh.all_reduce_ = counted(mesh.all_reduce_)
    mesh.gather_cat = counted(mesh.gather_cat)
    return calls


@contextlib.contextmanager
def _plain_stack_under_cross_rank_stats():
    """The rule of the port before the pooled-MLP kernel took cross-rank
    moments: under ``cross_rank_stats`` every SetConv takes the plain
    stack."""
    import tpugan_tpu_torch.nn.layers as layers
    import tpugan_tpu_torch.nn.setconv as setconv

    own = setconv.fusable_stats
    setconv.fusable_stats = lambda: own() and layers._STAT_REDUCE is None
    try:
        yield
    finally:
        setconv.fusable_stats = own


def _state_tensors(state):
    """Parameters, buffers and Adam moments of the three networks."""
    out = {"n_iter": state.n_iter}
    for name in ("sr", "tempo", "spatial"):
        net = getattr(state, name)
        out[name] = {"sd": {k: v.clone() for k, v in
                            net.module.state_dict().items()},
                     "mu": dict(net.opt.mu), "nu": dict(net.opt.nu),
                     "count": net.opt.count}
    return out


def _steps(inp, make_step, groups):
    """For each run of ``inp["runs"]`` (a trainer state, the global batch
    and the global draws) one step per ``groups`` entry (its name, its
    group, None for the single-process step, and whether the rank takes
    the whole batch), each from a copy of the state, with its calls of the
    pooled-MLP kernel and its collectives; a run with ``references`` False
    takes the data-parallel step alone. The entry "dp_plain_stack" is the
    data-parallel step with every SetConv on the plain stack."""
    import copy

    from tpugan_tpu_torch.parallel import mesh
    from tpugan_tpu_torch.train.step import DataParallel

    calls, collectives = _pooled_counter(), _collective_counter()
    out = []
    for run in inp["runs"]:
        got = {}
        for what, group, whole in groups:
            if what != "dp" and not run.get("references", True):
                continue
            state = copy.deepcopy(run["state"])
            step = make_step(run["cfg"])
            step.dp = None if group is None else DataParallel(group)
            batch = run["batch"] if whole else mesh.batch_sharded(run["batch"])
            calls[0] = collectives[0] = 0
            with (_plain_stack_under_cross_rank_stats()
                  if what == "dp_plain_stack" else contextlib.nullcontext()):
                metrics = step(state, {k: v.contiguous()
                                       for k, v in batch.items()},
                               run["draws"])
            got[what] = {"metrics": metrics, "state": _state_tensors(state),
                         "pooled_calls": calls[0],
                         "collectives": collectives[0]}
        out.append(got)
    return out


def _pooled_split(inp):
    """The fused pooled SharedMLP in train mode on this rank's rows of
    ``inp["table"]`` under ``cross_rank_stats`` (the kernel's plain split
    with the cross-rank sum) and the plain stack + max under the same
    context, each from the same module state, with the cotangent's rows:
    pooled output, running moments, the gradients of the table, weights,
    scales and biases; and the moments ``pooled_mlp_bn_train`` returns."""
    import copy

    from tpugan_tpu_torch.nn.layers import (SharedMLP, cross_rank_stats,
                                            leaky_relu_001)
    from tpugan_tpu_torch.ops.kernels.pooled_mlp import pooled_mlp_bn_train
    from tpugan_tpu_torch.parallel import mesh

    world, r = mesh.world_size(), mesh.rank()
    table = mesh.shard_rows(inp["table"], 0, world, r)
    g = mesh.shard_rows(inp["g"], 0, world, r)
    mlp = SharedMLP(table.shape[-1], inp["widths"], act=leaky_relu_001,
                    norm="batch", use_bias=False,
                    generator=torch.Generator().manual_seed(inp["seed"]),
                    device="cpu")
    mlp.load_state_dict(inp["state_dict"])
    out = {}
    for name, fused in (("split", True), ("stack", False)):
        m = copy.deepcopy(mlp)
        x = table.clone().requires_grad_()
        with cross_rank_stats(lambda t: mesh.all_reduce(t), world):
            y = m.pooled(x, True) if fused else m(x, True).amax(dim=2)
        (y * g).sum().backward()
        out[name] = {"pooled": y.detach(), "table_grad": x.grad,
                     "state": {k: v.clone() for k, v in m.state_dict().items()},
                     "grads": {k: p.grad.clone()
                               for k, p in m.named_parameters()}}
    layers_ = list(mlp.children())
    with torch.no_grad():
        _, mus, vars_ = pooled_mlp_bn_train(
            table, [l.weight(False).t() for l in layers_],
            [l.BatchNorm_0.scale for l in layers_],
            [l.BatchNorm_0.bias for l in layers_], 0.01,
            reduce=lambda t: mesh.all_reduce_(t.clone()), world=world)
    out["moments"] = (mus, vars_)
    return out


def _chain(inp):
    """Two consecutive data-parallel fluid steps from ``inp["state"]`` on
    ``inp["batches"]`` and ``inp["draws"]``: the state between them (a
    copy, and its tensors) and the second step's metrics and state."""
    import copy

    from tpugan_tpu_torch.parallel import mesh
    from tpugan_tpu_torch.train.step import FluidGanStep

    state = copy.deepcopy(inp["state"])
    step = FluidGanStep(inp["cfg"], data_parallel=True)
    rows = lambda b: {k: v.contiguous()
                      for k, v in mesh.batch_sharded(b).items()}
    step(state, rows(inp["batches"][0]), inp["draws"][0])
    mid = copy.deepcopy(state)
    metrics = step(state, rows(inp["batches"][1]), inp["draws"][1])
    return mid, {"mid": _state_tensors(mid),
                 "dp": {"metrics": metrics, "state": _state_tensors(state)}}


def case_steps(inp):
    """The data-parallel fluid and action steps of ``inp["fluid"]`` and
    ``inp["action"]`` at the world's size (the fluid ones also with every
    SetConv on the plain stack); the pooled split of ``inp["pooled"]``
    (:func:`_pooled_split`), where given; two consecutive data-parallel
    fluid steps of ``inp["chain"]`` (:func:`_chain`), where given; then,
    with ``inp["references"]``, the single-process references on the whole
    batch, shared out so the ranks work at once: rank 0 runs the fluid ones
    in a group of that rank alone (world size 1) and without data
    parallelism, and the chain's second step without it from the state the
    ranks held between the two; the last rank the action ones without
    it."""
    import copy

    import torch.distributed as dist

    from tpugan_tpu_torch.parallel import mesh
    from tpugan_tpu_torch.train.step import ActionGanStep, FluidGanStep

    fluid = lambda cfg: FluidGanStep(cfg, data_parallel=True)
    action = lambda cfg: ActionGanStep(cfg, data_parallel=True)
    dp = [("dp", mesh.DATA_AXIS, False)]
    out = {"fluid": _steps(inp["fluid"], fluid,
                           dp + [("dp_plain_stack", mesh.DATA_AXIS, False)]),
           "action": _steps(inp["action"], action, dp)}
    if "pooled" in inp:
        out["pooled"] = _pooled_split(inp["pooled"])
    mid = None
    if "chain" in inp:
        mid, out["chain"] = _chain(inp["chain"])
    if inp.get("references"):
        world, r = mesh.world_size(), mesh.rank()
        alone = [dist.new_group([i]) for i in range(world)][0]
        refs = []
        if r == 0:
            refs.append(("fluid", fluid, [("alone", alone, True),
                                          ("plain", None, True)]))
            if mid is not None:     # (mid's dump holds its Adam moments)
                c, single = inp["chain"], copy.deepcopy(mid)
                metrics = FluidGanStep(c["cfg"])(single, c["batches"][1],
                                                 c["draws"][1])
                out["chain"]["plain"] = {"metrics": metrics,
                                         "state": _state_tensors(single)}
        if r == world - 1:
            refs.append(("action", action, [("plain", None, True)]))
        for name, make, groups in refs:
            for got, more in zip(out[name], _steps(inp[name], make, groups)):
                got.update(more)
    return out


CASES = {"ops": case_ops, "serving": case_serving, "steps": case_steps}


def main(case, workdir):
    import torch.distributed as dist

    from tpugan_tpu_torch.parallel import mesh

    mesh.initialize_distributed(device="cpu")
    inputs = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    out = CASES[case](inputs)
    torch.save(out, os.path.join(workdir, f"rank{mesh.rank()}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:])
