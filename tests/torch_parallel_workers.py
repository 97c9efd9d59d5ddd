"""What the ranks of tests/test_torch_parallel.py run, in processes of their
own (parallel/launch.py spawns them): torch and the port only, no JAX.

`run(path)` is each rank's entry: it reads the jobs the test wrote to
`path` (torch.save of [(name, kwargs)]), runs each `JOBS[kwargs["job"]]`
in order, and writes {name: result} to `<path>.rank<r>`. Results hold
tensors on the CPU and Python numbers.
"""

import copy
import os
import shutil

import torch

from simple_sfod_tpu_torch.config import get_cfg
from simple_sfod_tpu_torch.data.synthetic import register_synthetic
from simple_sfod_tpu_torch.engine.trainers import build_trainer
from simple_sfod_tpu_torch.engine.trainers.base import _jsonable
from simple_sfod_tpu_torch.models.backbones.vgg import BatchNorm2d
from simple_sfod_tpu_torch.models.heads import FastRCNNConvFCHead
from simple_sfod_tpu_torch.parallel import mesh


def make_cfg(opts, output_dir, yaml=None):
    cfg = get_cfg()
    if yaml:
        cfg.merge_from_file(yaml, allow_new=True)
    cfg.merge_from_list(list(opts))
    cfg.OUTPUT_DIR = output_dir
    return cfg


def full_state(trainer):
    """The trainer's checkpoint content with the full box heads, on the
    CPU, and a hash of its student and teacher."""
    with trainer.full_state():
        data = copy.deepcopy({k: v for k, v in trainer.checkpoint_state().items() if k != "trainer"})
        thresh = getattr(trainer.state, "thresh", None)
        data["thresh"] = copy.deepcopy(thresh.state_dict()) if thresh is not None else None
        data["hash"] = mesh.state_hash(trainer.state)
    return data


def job_steps(opts, output_dir, batches, draws, states=None, weights=None, yaml=None, **_):
    """Build the trainer of `opts` (over `yaml` where given; seeded, or
    `weights`: a TeacherStudentWeights or a detector state dict) and take
    one step a batch on the global draws (None: the trainer's own, drawn for
    the global batch); a batch is a (source, target) pair for the paired
    trainers. Before step i, restore `states[i]` where given (a
    checkpoint_state-like dict of full tensors). -> per step: the global
    metrics and the full state."""
    kw = {}
    if weights is not None:
        kw = {"weights": weights} if hasattr(weights, "student") else {"state_dict": weights}
    trainer = build_trainer(make_cfg(opts, output_dir, yaml), device="cpu", **kw)
    out = []
    for i, (batch, d) in enumerate(zip(batches, draws)):
        if states is not None and states[i] is not None:
            data = dict(states[i])
            data.setdefault("trainer", {})
            data["trainer"] = {**trainer.checkpoint_state()["trainer"], **data["trainer"]}
            with trainer.full_state():
                trainer.load_checkpoint(data)
        if isinstance(batch, tuple):  # (source, target)
            metrics = trainer.run_step(batch[0], d, target=batch[1])
        else:
            metrics = trainer.run_step(batch, d)
        metrics = mesh.sum_metrics(metrics, trainer.layout)
        out.append({"metrics": {k: float(v) for k, v in metrics.items()}, "state": full_state(trainer)})
    return out


def job_bn(x, weight, bias, gy, **_):
    """A BatchNorm2d in train mode on this rank's rows of x under
    data_parallel: (y, the input gradient of its rows, the weight and bias
    gradients summed over the ranks, the running statistics)."""
    lay = mesh.make_layout(mesh.world_size(), 1)
    bn = BatchNorm2d(x.shape[1])
    with torch.no_grad():
        bn.weight.copy_(weight)
        bn.bias.copy_(bias)
    xs = mesh.shard_batch(lay, x, x.shape[0]).clone().requires_grad_(True)
    gys = mesh.shard_batch(lay, gy, x.shape[0])
    with mesh.data_parallel(lay):
        y = bn(xs, train=True, update_stats=True)
    (y * gys).sum().backward()
    if lay is not None:
        mesh.all_reduce_grads([bn.weight, bn.bias], lay)
    return {"y": y.detach(), "gx": xs.grad, "gw": bn.weight.grad, "gb": bn.bias.grad,
            "mean": bn.running_mean.clone(), "var": bn.running_var.clone()}


def job_tp_head(**_):
    """A box head with dropout 0.5 split over all ranks (data 1 x model W)
    against the whole head on the same input, weights and keep masks ->
    the largest difference of the output, the input gradient and each
    parameter's gradient (this rank's slice of it), relative to the whole
    head's largest entry."""
    lay = mesh.make_layout(1, mesh.world_size())
    g = torch.Generator().manual_seed(0)
    head = FastRCNNConvFCHead(16 * 2 * 2, 64, 2, dropout=0.5)
    for p in head.parameters():
        p.data = torch.randn(p.shape, generator=g) * 0.1
    x = torch.randn(6, 16, 2, 2, generator=g)
    keep = tuple(torch.rand(6, 64, generator=g) < 0.5 for _ in range(2))
    gy = torch.randn(6, 64, generator=g)

    def run(h, k):
        xi = x.clone().requires_grad_(True)
        y = h(xi, k)
        (y * gy).sum().backward()
        return {"y": y.detach(), "x": xi.grad, **{n: p.grad for n, p in h.named_parameters()}}

    whole = run(copy.deepcopy(head), keep)
    tp = copy.deepcopy(head)
    mesh.shard_box_head(tp, lay)
    split = run(tp, mesh.slice_box_keep(keep, lay))
    k, m = 64 // lay.model, lay.model_index
    whole["fc1.weight"] = whole["fc1.weight"][m * k:(m + 1) * k]
    whole["fc1.bias"] = whole["fc1.bias"][m * k:(m + 1) * k]
    whole["fc2.weight"] = whole["fc2.weight"][:, m * k:(m + 1) * k]
    return {n: float((split[n] - w).abs().max() / w.abs().max()) for n, w in whole.items()}


def job_eval_adabn(opts, output_dir, per_rank_dir=False, adabn_batches=2, **_):
    """test() (the trainer's evaluation on synthetic_test), then
    adabn_refinement over `adabn_batches` batches; with `per_rank_dir` each
    rank writes under its own directory (to see which ranks write)."""
    register_datasets()
    if per_rank_dir:
        output_dir = os.path.join(output_dir, f"rank{mesh.rank()}")
    trainer = build_trainer(make_cfg(opts, output_dir), device="cpu", synthetic=True)
    first = _jsonable(trainer.test())
    dump = os.path.join(output_dir, "inference", "coco_instances_results.json")
    dump = open(dump).read() if os.path.exists(dump) else None
    second = _jsonable(trainer.adabn_refinement(max_batches=adabn_batches))
    bn = {k: v.clone() for k, v in trainer.state.model.state_dict().items() if "running_" in k}
    return {"test": first, "dump": dump, "adabn": second, "bn": bn, "files": sorted(_walk(output_dir))}


def register_datasets():
    """The synthetic datasets of the tests' configs (names of their own, so
    no other test's registration is replaced): 8 train and target images,
    5 test images (3 batches of 2, the last padded)."""
    register_synthetic("parallel_train", num_images=8, num_classes=4)
    register_synthetic("parallel_target", num_images=8, num_classes=4, seed=2)
    register_synthetic("parallel_test", num_images=5, num_classes=4, seed=1)


def _walk(root):
    for d, _, files in os.walk(root):
        for f in files:
            yield os.path.relpath(os.path.join(d, f), root)


def job_train(opts, output_dir, resume=False, copy_from=None, **_):
    """train() with --resume semantics on synthetic data (every step on the
    loader's batches and the trainer's own draws); `copy_from` is copied to
    `output_dir` first by rank 0. -> the full state at the end."""
    register_datasets()
    if copy_from is not None:
        if mesh.is_main():
            shutil.copytree(copy_from, output_dir)
        mesh.barrier()
    trainer = build_trainer(make_cfg(opts, output_dir), device="cpu", synthetic=True)
    trainer.resume_or_load(resume=resume)
    trainer.train()
    return full_state(trainer)


def job_preempt(opts, output_dir, flag_rank=1, flag_step=3, **_):
    """train() with SIGTERM's flag raised on rank `flag_rank` alone as its
    step `flag_step` starts. -> the steps taken and the files written."""
    register_datasets()
    trainer = build_trainer(make_cfg(opts, output_dir), device="cpu", synthetic=True)
    trainer.resume_or_load(resume=False)
    step_staged = trainer.step_staged

    def step(*args, **kw):
        if mesh.rank() == flag_rank and trainer.state.step == flag_step:
            trainer._preempted = True
        return step_staged(*args, **kw)

    trainer.step_staged = step
    trainer.train()
    return {"step": trainer.state.step, "files": sorted(_walk(output_dir)) if mesh.is_main() else None}


def job_bands(cases, **_):
    """parallel/dryrun.py:compare_bands on this rank (data 1 x model W)."""
    from simple_sfod_tpu_torch.parallel.dryrun import compare_bands

    return compare_bands(cases)


JOBS = {"preempt": job_preempt, "steps": job_steps, "bn": job_bn, "tp_head": job_tp_head, "eval_adabn": job_eval_adabn,
        "train": job_train, "bands": job_bands}


def run(path):
    torch.set_num_threads(2)
    jobs = torch.load(path, weights_only=False)
    out = {}
    for name, kw in jobs:
        out[name] = JOBS[kw["job"]](**kw)
        mesh.barrier()
    torch.save(out, f"{path}.rank{mesh.rank()}")


def results(path, world):
    """Every rank's results of `run(path)`, in rank order."""
    return [torch.load(f"{path}.rank{r}", weights_only=False) for r in range(world)]


def spawn(path, jobs, world=2):
    """Write `jobs` to `path`, run them on `world` gloo ranks on the CPU and
    return every rank's results."""
    from simple_sfod_tpu_torch.parallel.launch import launch

    torch.save(jobs, path)
    launch(run, world, device="cpu", args=(str(path),), threads=2)
    return results(path, world)


def one_process(jobs):
    """The same jobs in this process, without a group and on the ranks' 2
    threads (another thread count sums convolutions in another order):
    {name: result}."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        return {name: JOBS[kw["job"]](**kw) for name, kw in jobs}
    finally:
        torch.set_num_threads(threads)

