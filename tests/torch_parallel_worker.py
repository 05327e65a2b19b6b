"""Ranks of the port's data-parallel tests (``tests/test_torch_parallel_*``).

Each rank is a process of its own, started by ``torch.multiprocessing.spawn``
from a test; it imports no JAX, takes one torch thread, joins a gloo group
through a ``file://`` rendezvous under the test's ``tmp_path`` (every
collective times out after ``TIMEOUT_S``), runs the tasks it is given in
order and saves each task's outputs as ``<tmp>/<task>_<rank>.pt``.
"""

import datetime
import uuid

import torch
import torch.distributed as dist

TIMEOUT_S = 120
BASE = 16
SIZES = (32, 64, 128, 256)


def spawn(tmp, world: int, tasks) -> dict:
    """Run ``tasks`` (``[(name, kwargs)]``, each ``name`` a function of
    this module) on ``world`` ranks; returns ``{name: [rank 0's outputs,
    ...]}``."""
    return finish(start(tmp, world, tasks), tmp, tasks)


def start(tmp, world: int, tasks):
    """Start :func:`spawn`'s ranks and return at once; :func:`finish`
    waits for them."""
    rendezvous = f"{tmp}/rendezvous_{uuid.uuid4().hex}"
    return torch.multiprocessing.spawn(
        _rank, args=(world, str(tmp), rendezvous, tasks), nprocs=world,
        join=False)


def finish(ranks, tmp, tasks) -> dict:
    """Wait for the ranks :func:`start` returned (a failing rank raises);
    returns :func:`spawn`'s outputs."""
    while not ranks.join():
        pass
    return {name: [torch.load(f"{tmp}/{name}_{r}.pt", weights_only=False)
                   for r in range(len(ranks.processes))]
            for name, _ in tasks}


def _rank(rank: int, world: int, tmp: str, rendezvous: str, tasks) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{rendezvous}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    from pdgn_tpu_torch.parallel import make_mesh

    try:
        mesh = make_mesh("cpu")
        for name, kwargs in tasks:
            torch.save(globals()[name](mesh, **kwargs),
                       f"{tmp}/{name}_{rank}.pt")
    finally:
        dist.destroy_process_group()


def bn(mesh, x, scale, bias, ct):
    """The synced functional batch norm and its input gradient on this
    rank's rows of ``x`` (through a ``DataAxis``, as the models' batch-norm
    sites reduce), and the per-replica one."""
    from pdgn_tpu_torch.parallel import (DataAxis, batch_norm,
                                         per_replica_batch_norm)

    rows = mesh.rows(x.shape[0])
    xr = torch.from_numpy(x[rows]).requires_grad_(True)
    sc, bi = torch.from_numpy(scale), torch.from_numpy(bias)
    axis = DataAxis(mesh.group)
    axis.begin(xr.shape[0], x.shape[0])
    y = batch_norm(xr, sc, bi, axis=axis)
    (y * torch.from_numpy(ct[rows])).sum().backward()
    return dict(y=y.detach(), dx=xr.grad,
                local=per_replica_batch_norm(xr.detach(), sc, bi))


def build_models(g_state, d_states, group=None, dtype=torch.float32):
    """The small generator and the four discriminators from state dicts, in
    ``dtype`` (float64: the arbiter's)."""
    from pdgn_tpu_torch.models import discriminator as tdisc
    from pdgn_tpu_torch.models.generator import PointGenerator

    G = PointGenerator(num_point=SIZES[-1], base_points=BASE, group=group)
    G.load_state_dict(g_state)
    Ds = []
    for i, sd in enumerate(d_states, 1):
        D = getattr(tdisc, f"PointDiscriminator{i}")(group=group)
        D.load_state_dict(sd)
        Ds.append(D.to(dtype))
    return G.to(dtype), Ds


def step_outputs(state, metrics) -> dict:
    """What the tests compare after a step: the metrics, each model's Adam
    first moment and gradient (flat), its parameters and its state dict."""
    from pdgn_tpu_torch.train.train_step import METRICS

    out = dict(metrics=torch.stack([metrics[k] for k in METRICS]),
               step=state.step)
    for name, m, opt in [("G", state.generator, state.g_opt)] + [
            (f"D{i}", d, o) for i, (d, o) in
            enumerate(zip(state.discriminators, state.d_opts), 1)]:
        params = list(m.parameters())
        out[name] = dict(
            names=[n for n, _ in m.named_parameters()],
            exp_avg=torch.cat([opt.state[p]["exp_avg"].flatten()
                               for p in params]),
            grad=torch.cat([p.grad.flatten() for p in params]),
            params=torch.cat([p.detach().flatten() for p in params]),
            state={k: v.clone() for k, v in m.state_dict().items()})
    return out


def run_step(mesh, g_state, d_states, reals, noise_d, noise_g,
             dtype=torch.float32):
    """One train step from the state dicts, the global clouds (numpy) and
    the global noise: on this rank's rows under a ``mesh``, else on all."""
    from pdgn_tpu_torch.parallel import shard_batch
    from pdgn_tpu_torch.train.train_step import (TrainConfig, init_state,
                                                 train_step)

    G, Ds = build_models(g_state, d_states, dtype=dtype)
    state = init_state(G, Ds, TrainConfig(), mesh)
    reals = [torch.from_numpy(r).to(dtype) for r in reals]
    if mesh is not None:
        reals = shard_batch(mesh, reals)
    metrics = train_step(state, reals, torch.from_numpy(noise_d).to(dtype),
                         torch.from_numpy(noise_g).to(dtype), TrainConfig())
    return step_outputs(state, metrics)


def step(mesh, **kwargs):
    """:func:`run_step` on this rank's rows, in float32."""
    return run_step(mesh, **kwargs)


def step64(mesh, **kwargs):
    """:func:`run_step` on this rank's rows, in float64."""
    return run_step(mesh, dtype=torch.float64, **kwargs)


def step_alone(mesh, **kwargs):
    """:func:`run_step` on rank 0 as the one rank of a group of its own
    (every rank takes part in making the group; the others return None)."""
    from pdgn_tpu_torch.parallel import make_mesh

    group = dist.new_group([0])
    if mesh.rank:
        return None
    return run_step(make_mesh("cpu", group), **kwargs)


def pairwise(mesh, sample, ref, tile):
    """``pairwise_cd_emd`` with this rank's share of the row tiles."""
    from pdgn_tpu_torch.eval.metrics import pairwise_cd_emd

    return pairwise_cd_emd(sample, ref, tile=tile, mesh=mesh, device="cpu")


def generate(mesh, g_state, n, batch_size, seed):
    """``generate()`` with whole batches on the ranks in turn, from a
    generator whose batch norms are synced (as the trainer's)."""
    from pdgn_tpu_torch.models.generator import PointGenerator
    from pdgn_tpu_torch.train.generate import generate as gen

    G = PointGenerator(num_point=SIZES[-1], base_points=BASE,
                       group=mesh.group)
    G.load_state_dict(g_state)
    return gen(n, batch_size, seed, device="cpu", model=G, mesh=mesh)


def graphs(mesh, g_state, d_states, reals, noise_d, noise_g,
           dtype=torch.float32):
    """The generator's kNN graphs of both noises' forwards (eval mode: the
    running statistics stay), on this rank's rows under a ``mesh``."""
    from pdgn_tpu_torch.parallel import set_group

    G, _ = build_models(g_state, d_states, dtype=dtype)
    if mesh is not None:
        set_group(G, mesh.group)
    G.eval()
    out = []
    for z in (noise_d, noise_g):
        z = torch.from_numpy(z).to(dtype)
        rows = slice(None) if mesh is None else mesh.rows(z.shape[0])
        with torch.no_grad():
            out.append(G(z[rows], return_graphs=True, batch=z.shape[0])[1])
    return out
