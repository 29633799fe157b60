"""Jobs for the multi-process training tests (``test_torch_train_dist.py``):
each runs the same on every rank of a world and in one process, so a test
holds N ranks against one. Imports torch and the port only: run as a
rank, ``python tests/torch_dist_jobs.py SPEC OUT`` (launched with
torchrun's environment by ``parallel/launch.py``) runs every job of the
spec (``torch.save``d: a list of job dicts, modules pickled whole) on the
CPU and saves each job's result to ``OUT/rank<r>.pt``.

Jobs:
  - ``dp``: a family's data-parallel step over ``steps`` (batch, draws),
    AdamW; a step without draws draws them from a generator seeded with
    the job's ``seed``, the same on every rank;
  - ``gan``: the vocoder's disc and gen steps over ``steps`` (sine draws
    likewise);
  - ``sp``: the sequence-parallel cascade step on a dp x sp mesh, once;
  - ``collectives``: the gradients of ``TimeGroup``'s halo exchange, sum
    and gather, each rank's loss a weighted sum of their outputs.
Each returns, for each step, the metrics, the gradients summed over the
ranks, the parameters and buffers and AdamW's moments after it.
"""
import copy
import os
import sys

import torch


def _tensors(d):
    return None if d is None else {k: torch.as_tensor(v) for k, v in d.items()}


def _state_of(state, prefix="") -> dict:
    """After a step: the parameters and buffers, AdamW's moments, and the
    step's gradients (summed over the ranks)."""
    opt, named = state.optimizer.state, dict(state.model.named_parameters())
    return {
        "params": {prefix + k: v.detach().clone()
                   for k, v in state.model.state_dict().items()},
        "mu": {prefix + n: opt[p]["exp_avg"].clone() for n, p in named.items()
               if p in opt},
        "nu": {prefix + n: opt[p]["exp_avg_sq"].clone() for n, p in named.items()
               if p in opt},
        "grads": {prefix + n: p.grad.clone() for n, p in named.items()
                  if p.grad is not None}}


def _both(a: dict, b: dict) -> dict:
    return {k: {**a[k], **b[k]} for k in a}


def _collective_grads(job: dict, mesh) -> dict:
    """x_r (n,) on rank r, requiring grad; rank r's loss is a weighted sum
    of all_gather(x), of psum(x), and of the halos exchange(x[-h:], x[:h])
    returns (h = n / 2), the weights W[r] of one seeded draw W (size, 3,
    size, n) -> x_r's gradient under each (the rank's share of the global
    loss's gradient)."""
    group, r, n = mesh.time, mesh.time.rank, job["n"]
    w = torch.randn((group.size, 3, group.size, n),
                    generator=torch.Generator().manual_seed(job["seed"]))[r]
    h, out = n // 2, {}
    for i, name in enumerate(("all_gather", "psum", "exchange")):
        x = torch.arange(n, dtype=torch.float32).add(r).requires_grad_()
        if name == "all_gather":
            loss = (w[i] * group.all_gather(x)).sum()
        elif name == "psum":
            loss = (w[i, 0] * group.psum(x)).sum()
        else:
            left, right = group.exchange(x[-h:], x[:h])
            loss = (w[i, 0, :h] * left).sum() + (w[i, 1, :h] * right).sum()
        loss.backward()
        out[name] = x.grad
    return out


def run_job(job: dict, mesh) -> list:
    """One job on this rank (``mesh`` None: one process) -> a record per
    step."""
    from ddsp_svc_tpu_torch.train.state import create_train_state

    kind = job["kind"]
    if kind == "collectives":
        return [_collective_grads(job, mesh)]
    if kind == "gan":
        from ddsp_svc_tpu_torch.train.vocoder_solver import (create_states,
                                                             disc_step, gen_step)

        state_g, state_d = create_states(copy.deepcopy(job["generator"]),
                                         copy.deepcopy(job["discriminators"]),
                                         job["lr"])
        out, rng = [], torch.Generator().manual_seed(job["seed"])
        for batch, sd, sg in job["steps"]:
            batch = _tensors(batch)
            md = disc_step(state_d, state_g.model, batch, _tensors(sd), rng,
                           mesh=mesh)
            mg = gen_step(state_g, state_d.model, batch, job["mel"].extract,
                          _tensors(sg), rng, mesh=mesh)
            out.append(dict(_both(_state_of(state_g, "generator."),
                                  _state_of(state_d, "discriminators.")),
                            metrics={k: float(v) for k, v in {**md, **mg}.items()}))
        return out
    model = copy.deepcopy(job["model"])
    state = create_train_state(model, lr=job["lr"],
                               weight_decay=job.get("weight_decay", 0.0))
    if kind == "sp":
        from ddsp_svc_tpu_torch.parallel.train_sp import make_sp_cascade_train_step

        step = make_sp_cascade_train_step(model, job["mel"], mesh,
                                          family=job["family"],
                                          k_step_max=job.get("k_step_max"))
        batch, draws = job["steps"][0]
        m = step(state, _tensors(batch), draws=_tensors(draws))
        return [dict(_state_of(state), metrics={k: float(v) for k, v in m.items()})]
    from ddsp_svc_tpu_torch.train import steps as st

    if job["family"] == "ddsp":
        step = st.make_ddsp_train_step(mesh=mesh)
    else:
        step = st.make_cascade_train_step(job["mel"].extract,
                                          k_step_max=job.get("k_step_max"),
                                          family=job["family"], mesh=mesh)
    out, rng = [], torch.Generator().manual_seed(job["seed"])
    for batch, draws in job["steps"]:
        m = step(state, _tensors(batch), rng, _tensors(draws))
        out.append(dict(_state_of(state), metrics={k: float(v) for k, v in m.items()}))
    return out


def main(spec_path: str, out_dir: str) -> None:
    import torch.distributed as dist

    from ddsp_svc_tpu_torch.parallel import mesh as mesh_lib

    torch.set_num_threads(1)
    mesh_lib.join_launched_world("cpu")
    try:
        results = []
        for job in torch.load(spec_path, weights_only=False):
            mesh = mesh_lib.make_mesh(job.get("dp"), job.get("sp", 1), "cpu")
            results.append(run_job(job, mesh))
        torch.save(results, os.path.join(out_dir, f"rank{dist.get_rank()}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    main(*sys.argv[1:3])
