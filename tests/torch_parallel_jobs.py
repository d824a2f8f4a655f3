"""What the ranks of the parallel tests run (``torch_world.run_world``).
Imports torch and the port only; the JAX references are made in the test
process and come in the payload."""

import numpy as np
import torch
import torch.distributed as dist


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _pipe(payload):
    from instarevive_tpu_torch.pipelines.build import build_pipeline, load_state_dicts

    return load_state_dicts(build_pipeline(payload["tiny"], device="cpu"), **payload["sds"])


def _toy(spec):
    from instarevive_tpu_torch.models.pixart import PixArt

    dit = PixArt(**spec["cfg"]).eval().requires_grad_(False)
    dit.load_state_dict({k: _t(v) for k, v in spec["sd"].items()})
    return dit


def _refused(fn):
    try:
        fn()
    except (NotImplementedError, ValueError) as exc:
        return f"{type(exc).__name__}: {exc}"
    return None


def inference(rank, n, payload):
    """Every inference mode of the slice on a world of 4: data parallelism on
    ranks {0, 1} while tensor parallelism runs on {2, 3}, then TP x DP over
    all four, the pipeline's sp (4) and pp (2), the toy DiT's sp (2, 4,
    masked) and pp at (stages, microbatches) (4, 2), (2, 4), (4, 1), and the
    refusals."""
    from instarevive_tpu_torch.parallel.pp import PipelineDiT
    from instarevive_tpu_torch.parallel.sp import pixart_sp_forward

    world = dist.group.WORLD
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    datas = [dist.new_group([0, 2]), dist.new_group([1, 3])]
    pair, data = pairs[rank // 2], datas[rank % 2]
    lq4, y4, lq2, y2 = (_t(payload[k]) for k in ("lq4", "y4", "lq2", "y2"))
    out = {}
    with torch.inference_mode():
        if rank < 2:
            out["sharded"] = _pipe(payload).sharded(pair)(lq4, y4).numpy()
        else:
            pipe = _pipe(payload)
            out["tp_one_card_state"] = {k: v.numpy().copy() for k, v in pipe.dit.state_dict().items()}
            out["tp"] = pipe.tp(pair)(lq4, y4).numpy()
            out["tp_state"] = {k: v.numpy() for k, v in pipe.dit.state_dict().items()}
        out["tp_dp"] = _pipe(payload).tp(pair, data)(lq4, y4).numpy()
        out["sp4_process"] = _pipe(payload).sp(world)(lq2, y2).numpy()
        pipe = _pipe(payload)
        pp = pipe.pp(pair, 2)
        out["pp2_process"] = pp(lq2, y2).numpy()
        out["pp2_process_again"] = pp(lq2.flip(0), y2).numpy()  # the stage modules are the cache
        out["pp2_blocks_held"] = len(pipe.dit.blocks)

        sp, pp_toy = payload["toy_sp"], payload["toy_pp"]
        args = [_t(sp[k]) for k in ("x", "t", "y")]
        out["sp2"] = pixart_sp_forward(_toy(sp), pair, *args).numpy()
        out["sp4"] = pixart_sp_forward(_toy(sp), world, *args).numpy()
        out["sp2_masked"] = pixart_sp_forward(_toy(sp), pair, *args, _t(sp["mask"])).numpy()
        args = [_t(pp_toy[k]) for k in ("x", "t", "y")]
        out["pp_4_2"] = PipelineDiT(_toy(pp_toy), world, 2)(*args).numpy()
        out["pp_2_4"] = PipelineDiT(_toy(pp_toy), pair, 4)(*args).numpy()
        out["pp_4_1"] = PipelineDiT(_toy(pp_toy), world, 1)(*args).numpy()
        out["pp_4_2_masked"] = PipelineDiT(_toy(pp_toy), world, 2)(*args, _t(pp_toy["mask"])).numpy()

        het = payload["toy_het"]
        hargs = [_t(het[k]) for k in ("x", "t", "y")]
        out["refuse_sp_heterogeneous"] = _refused(lambda: pixart_sp_forward(_toy(het), pair, *hargs))
        out["refuse_pp_heterogeneous"] = _refused(lambda: PipelineDiT(_toy(het), pair, 2))
        # 16 tokens over 3 ranks of no group: the check comes before any collective
        three = dist.new_group([0, 1, 2])
        if rank < 3:
            out["refuse_sp_tokens"] = _refused(lambda: pixart_sp_forward(_toy(sp), three, *args[:3]))
            out["refuse_pp_depth"] = _refused(lambda: PipelineDiT(_toy(pp_toy), three, 2))
        out["refuse_pp_batch"] = _refused(lambda: PipelineDiT(_toy(pp_toy), world, 3)(*args))
    return out


def serving(rank, n, payload):
    """The server's mesh flags on pairs of ranks: --data_parallel 2 on {0, 1}
    while --tensor_parallel 2 runs on {2, 3}, then --pipeline_parallel 2 and
    --seq_parallel 2, then --data_parallel 2 --tensor_parallel 2 on all four.
    Rank 0 of a group submits three 64x64 requests at once
    to a ``Batcher`` over its ``RankedRestorer`` and compares each answer with
    a one-process restorer's; under --data_parallel a follower then fails one
    batch (an all-black image) after its part, which must raise on rank 0 and
    leave both ranks serving the next request."""
    import threading

    from instarevive_tpu_torch import serve

    pair = [dist.new_group([0, 1]), dist.new_group([2, 3])][rank // 2]
    base = ["--device", "cpu", "--random_init", "--config", payload["config"]]
    xs, black = payload["xs"], np.zeros_like(payload["xs"][0])
    out = {}
    if rank % 2 == 0:
        out["plain"] = serve.build_restorer(serve.parse_args(base))(xs)
    rounds = [((f"--{m}", "2"), m, pair) for m in (("data_parallel", "tensor_parallel")[rank // 2],
                                                   ("pipeline_parallel", "seq_parallel")[rank // 2])]
    rounds.append((("--data_parallel", "2", "--tensor_parallel", "2"), "tp_dp", None))  # the world's 4 ranks
    for flags, mode, group in rounds:
        ranked = serve.serve_rank(serve.parse_args(base + list(flags)), group)
        if dist.get_rank(ranked.group):
            if mode == "data_parallel":
                part = ranked.part

                def failing(x, part=part):
                    y = part(x)
                    if not x.any():
                        raise RuntimeError("injected failure")
                    return y

                ranked.part = failing
            out[f"{mode}_follower_batches"] = ranked.follow()
            continue
        batcher = serve.Batcher(ranked, max_batch=4, batch_window_ms=300)
        answers = [None] * len(xs)

        def ask(i):
            answers[i] = batcher.submit(xs[i], 64, 64)

        threads = [threading.Thread(target=ask, args=(i,)) for i in range(len(xs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        out[mode] = np.stack(answers)
        if mode == "data_parallel":
            try:
                batcher.submit(black, 64, 64)
                out["failed"] = None
            except RuntimeError as exc:
                out["failed"] = str(exc)
            out["after_failure"] = batcher.submit(xs[0], 64, 64)
        out[f"{mode}_stats"] = batcher.stats()
        batcher.close()
        ranked.stop()
    return out


def train_argv(root, task, out, steps, *extra):
    return ["--device", "cpu", "--task", task, "--config", f"{root}/tiny.yaml", "--data", f"{root}/hq",
            "--out", f"{root}/{out}", "--batch_size", "4", "--crop_size", "64", "--steps", str(steps),
            "--log_every", "1", "--lr", "1e-4", "--warmup", "1", *extra]


def training(rank, n, payload):
    """The launcher's layout of a torchrun world of 4 at --fsdp 1 and 2; the
    DMD and SwinIR trainers under data parallelism on ranks {0, 1}
    while FSDP2 runs on {2, 3}, then HSDP (data 2 x fsdp 2) on all four; the
    cldm trainer under DDP(2) and FSDP2(2) side by side; then
    the FSDP2 DMD checkpoint resumed on four FSDP2 ranks; the JAX test's
    linear model under FSDP2 at 2 and at 2 x 2 (``jax_linear``); CAME on
    sharded weights and the shared finite-gradient flag (``came_steps``)."""
    from torch.distributed.device_mesh import init_device_mesh

    from instarevive_tpu_torch.parallel.mesh import TrainMesh
    from instarevive_tpu_torch.train import launcher

    root = payload["root"]
    out = {"torchrun_mesh": {}}
    for fsdp in (1, 2):  # the world the environment gives (WORLD_SIZE 4), laid out as the launcher does
        m = launcher.train_mesh(launcher.parse_args(train_argv(root, "dmd", "unused", 1, "--fsdp", str(fsdp))), [])
        out["torchrun_mesh"][fsdp] = (m.data, m.fsdp, m.rank, m.sharded)
    pair_data = init_device_mesh("cpu", (2, 2), mesh_dim_names=("pair", "data"))["data"]
    pair_fsdp = init_device_mesh("cpu", (2, 2), mesh_dim_names=("pair", "fsdp"))["fsdp"]
    hsdp = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "fsdp"))
    fsdp4 = init_device_mesh("cpu", (4,), mesh_dim_names=("fsdp",))
    for task in ("dmd", "swinir"):
        kind, mesh = ("ddp", pair_data) if rank < 2 else ("fsdp", pair_fsdp)
        out[f"{task}_{kind}"] = launcher.main(train_argv(root, task, f"{task}_{kind}", 2), mesh=TrainMesh(mesh)).history
        out[f"{task}_hsdp"] = launcher.main(train_argv(root, task, f"{task}_hsdp", 2), mesh=TrainMesh(hsdp)).history
    kind, mesh = ("ddp", pair_data) if rank < 2 else ("fsdp", pair_fsdp)
    out[f"cldm_{kind}"] = launcher.main(train_argv(root, "cldm", f"cldm_{kind}", 2, "--config",
                                                   f"{root}/cldm_tiny.yaml"), mesh=TrainMesh(mesh)).history
    out["dmd_resume4"] = launcher.main(
        train_argv(root, "dmd", "dmd_resume4", 3, "--resume", f"{root}/dmd_fsdp/final"), mesh=TrainMesh(fsdp4)).history
    out["linear_fsdp2"] = jax_linear(TrainMesh(pair_fsdp))
    out["linear_hsdp"] = jax_linear(TrainMesh(hsdp))
    out["came_fsdp2"] = came_steps(TrainMesh(pair_fsdp))
    out["came_hsdp"] = came_steps(TrainMesh(hsdp))
    return out


def jax_linear(mesh):
    """tests/test_parallel_train.py's sharded step: a (16, 32) linear model
    from ones, AdamW at 1e-2 with a one-step warm-up, an EMA; two steps on
    x = ones (8, 16), y = zeros (8, 32), the batch split over the ranks."""
    from instarevive_tpu_torch.train.optim import build_optimizer, constant_with_warmup
    from instarevive_tpu_torch.train.state import TrainState

    model = torch.nn.Linear(16, 32)
    with torch.no_grad():
        model.weight.fill_(1.0)
        model.bias.zero_()
    mesh.shard(model)
    state = TrainState.create(model, build_optimizer("adamw", constant_with_warmup(1e-2, 1)), ema=True)
    mesh.bind(state)
    x, y = mesh.local(torch.ones(8, 16)), mesh.local(torch.zeros(8, 32))
    losses = []
    for _ in range(2):
        loss = torch.mean((model(x) - y) ** 2)
        state.apply_gradients(state.gradients(loss))
        losses.append(float(mesh.mean({"loss": loss.detach()})["loss"]))
    return {"losses": losses, "params": state.module_state_dict(), "ema": state.ema_state_dict()}


class _LinConv(torch.nn.Module):
    """A 2-D, a 4-D and two 1-D parameters: every branch of CAME's factoring."""

    def __init__(self):
        super().__init__()
        self.lin = torch.nn.Linear(16, 32)
        self.conv = torch.nn.Conv2d(4, 6, 3)

    def forward(self, x, img):  # through the root, whose forward gathers the shards
        return self.lin(x), self.conv(img)


def came_steps(mesh, steps=3):
    """Three CAME steps (global-norm clip at 1, so it bites) on seeded data,
    the batch split over the ranks; the one-card optimizer state, weights and
    losses. Then a step whose gradient is not finite on this layout's first
    shard only: every rank must skip it."""
    from instarevive_tpu_torch.train.optim import build_optimizer
    from instarevive_tpu_torch.train.state import TrainState
    from instarevive_tpu_torch.utils.debug import nan_guard

    torch.manual_seed(0)
    model = _LinConv()
    mesh.shard(model)
    state = TrainState.create(model, build_optimizer("came", 1e-2, grad_clip_norm=1.0), ema=True)
    mesh.bind(state)
    g = torch.Generator().manual_seed(1)
    x, y, img = torch.randn(8, 16, generator=g), torch.randn(8, 32, generator=g), torch.randn(8, 4, 7, 7, generator=g)
    x, y, img = mesh.local(x), mesh.local(y), mesh.local(img)
    losses = []
    def loss_fn():
        lin, conv = model(x, img)
        return torch.mean((lin - y) ** 2) + torch.mean(conv ** 2)

    for _ in range(steps):
        loss = loss_fn()
        state.apply_gradients(state.gradients(loss))
        losses.append(float(mesh.mean({"loss": loss.detach()})["loss"]))
    before = state.module_state_dict()
    grads = state.gradients(loss_fn())
    if mesh.rank == 0:
        grads[0] = grads[0] + float("nan")
    ok = nan_guard(state, grads)
    after = state.module_state_dict()
    return {"losses": losses, "params": before, "ema": state.ema_state_dict(), "opt": state.opt_state_full(),
            "skipped": bool(~ok), "kept": all(torch.equal(before[k], after[k]) for k in before)}
