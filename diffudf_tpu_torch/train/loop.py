"""The training loop, on one device or data-parallel over a process group:
the torch counterpart of ``diffudf_tpu/train/loop.py``.

One *epoch* = ``batches_per_epoch`` (sample → loss → backward → Adam)
updates, the reference accounting (``train.py:146-283``).  Epochs run in
chunks of up to ``chunk_size``, cut at the s1→s2 boundary and at checkpoint
epochs; a callback fires after each chunk.  Stage, loss and learning rate
follow the epoch.  Everything a step touches stays on the device: the batch
is drawn from a ``torch.Generator`` there, the loss terms, the best loss and
the best params are device tensors, and the host reads the logs once per
chunk.

On a net the kernels take (``ops.evaluate.autograd_ops``, by
``ops.kernel_io.kernel_spec_ok``: a uniform-width sine SIREN of width a
multiple of 32, at most 256) the s1 loss runs the fused ops: K1 + K2 (``ops.vgh.vgh_op``) on the on-surface
rows and K3a + K3b (``ops.vg.vg_op``) on the others; on a CPU tensor those
ops run their plain versions.  Any other net takes the plain Taylor-mode
path, as the JAX package sends it to XLA.

Optimizer: Adam with torch-default hyperparameters (β=(0.9, 0.999),
ε=1e-8), optax's ``scale_by_adam`` written out, with the learning rate
multiplying the preconditioned update per step (``loop.py:20-22, 234`` of the
JAX package).  The learning rate and the bias corrections reach the update
as device scalars (:func:`adam_scalars`), so a captured step reads the
values of the step it replays.

CUDA graph: on one CUDA device, an s2 or siren epoch runs as one
``torch.cuda.CUDAGraph`` replay.  The draw stays eager, on the trainer's
generator, and its tensors are copied into the graph's input buffers; the
graph holds the loss, ``torch.autograd.grad``, the Adam updates, the
epoch's sums and the best-loss / best-params update, all in place on the
state.  The first epoch of a new key (stage, batch shapes,
``batches_per_epoch``, the state's tensors) runs the same step eagerly on a
side stream, the next captures it, and later epochs replay it.  CPU
tensors, a process group and s1 (whose kernels count their launches in
Python) take the eager step.

Random keys: the state carries a (2,) uint32 key.  Each chunk seeds the
sampling generator from it and replaces it by the next key of a fixed host
chain, so a run resumed from a saved state draws the batches the
uninterrupted run would have drawn.

Data parallelism (``group``, a :class:`..parallel.mesh.DataGroup` of more
than one rank; the JAX package's ``_build_sharded_batch_step`` and
``_build_constrained_batch_step``):

  * when every [surf|far|near] group of the batch divides the group size,
    each rank draws its own ``batch/size`` sub-batch
    (``TrainingSampler.local``) from a generator seeded by the chunk key
    and its rank (:func:`rank_key`) and runs the unchanged single-device
    loss on it, split Hessian and kernels included;
  * otherwise (a RuntimeWarning, the JAX text) every rank draws the whole
    batch from the single-device stream and takes its contiguous block of
    rows (``DataGroup.shard_rows``); the surface rows lead the batch, so a
    block's leading surface count is known and the split Hessian stays.

Either way a rank holding ``B_r`` of the batch's ``B`` rows weights each
s1/siren term by ``B_r / B`` (each term is a sum over the batch over its
row count) and the weighted terms are summed over the group by the
differentiable all-reduce; ``loss_s2`` sums its statistics over the group.
Every rank then holds the terms of the whole batch, and the gradient of
their sum is all-reduced and divided by the size (the all-reduce's backward
already summed the gradient over the ranks), so every rank applies the
gradient of the single-device loss on the union batch, bit for bit the
same on each.  The logged terms, ``is_best`` and the best params follow
from all-reduced values, so they agree across ranks too.
"""

from __future__ import annotations

import dataclasses
import time
import warnings

import numpy as np
import torch

from ..autodiff import ops as autodiff_ops
from ..config import TrainConfig
from ..data.sampling import TrainingSampler
from ..fields.siren import SirenSpec, init_siren
from ..ops.evaluate import autograd_ops
from ..parallel.mesh import DataGroup, single
from ..utils import timing
from ..utils.timing import span
from .checkpoint import AdamState
from .losses import loss_s1, loss_s2, loss_siren
from .schedule import lr_for_epoch, lr_for_epoch_siren

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8

# on-surface rows of the batches ``Trainer.epoch`` drew, since the count was
# last set to 0; over ``autodiff.ops.value_rows`` the value path's useful share
surface_rows = 0
# epochs ``Trainer.epoch`` ran by replaying a captured CUDA graph, by
# capturing one (and replaying it), and eagerly, since the counts were last
# set to 0: each epoch adds 1 to one of them
graph_replays = 0
graph_captures = 0
eager_steps = 0

TERM_NAMES = {
    "s1": ("sdf_on_surf", "sdf_off_surf", "hessian_constraint", "grad_constraint"),
    "s2": ("sdf_on_surf", "std_on_surf"),
    "siren": ("sdf_on_surf", "sdf_off_surf", "normal_constraint", "grad_constraint"),
}


@dataclasses.dataclass
class TrainState:
    params: list  # [{'w', 'b'}] leaf tensors
    opt_state: AdamState
    best_loss: torch.Tensor  # scalar f32 on the device
    best_params: list
    key: np.ndarray  # (2,) uint32: seeds the next chunk's generator


def key_from_seed(seed: int) -> np.ndarray:
    """The key ``jax.random.PRNGKey(seed)`` gives for a 32-bit seed."""
    return np.array([0, seed & 0xFFFFFFFF], np.uint32)


def next_key(key) -> np.ndarray:
    return np.random.default_rng(np.asarray(key, np.uint32)).integers(
        0, 2**32, 2, dtype=np.uint32)


def rank_key(key, rank: int) -> np.ndarray:
    """The key rank ``rank`` of a data-parallel group seeds a chunk's
    generator with, from the chunk's key: a fixed rule, so a resumed run
    draws the batches of the uninterrupted one."""
    seed = [int(k) for k in np.asarray(key, np.uint32)] + [int(rank)]
    return np.random.default_rng(seed).integers(0, 2**32, 2, dtype=np.uint32)


def generator_for(key, device) -> torch.Generator:
    key = np.asarray(key, np.uint32)
    seed = (int(key[0]) << 32) | int(key[1])
    return torch.Generator(device=device).manual_seed(seed)


def _leaves(params):
    return [t for layer in params for t in (layer["w"], layer["b"])]


def adam_scalars(counts, lr: float, device, out=None) -> torch.Tensor:
    """(len(counts), 3) float32 rows (lr, bc1, bc2) on ``device``, into
    ``out`` if given: the learning rate and optax's bias corrections
    ``1 - b ** count`` in float32, a row for each Adam step count.  On CUDA
    one host-to-device copy from a freshly allocated pinned buffer, which
    the caching host allocator keeps until the copy has run, so the host
    does not wait for the device."""
    b1, b2 = np.float32(ADAM_B1), np.float32(ADAM_B2)
    rows = [(float(np.float32(lr)), float(1 - b1 ** np.float32(c)), float(1 - b2 ** np.float32(c)))
            for c in counts]
    cuda = torch.device(device).type == "cuda"
    host = torch.tensor(rows, dtype=torch.float32, pin_memory=cuda)
    if out is None:
        return host.to(device, non_blocking=True)
    return out.copy_(host, non_blocking=True)


def adam_apply(params, grads, mu, nu, scalars):
    """One optax ``scale_by_adam`` step followed by ``p - lr * u``, in place
    on ``params`` and on the moments ``mu``, ``nu`` (leaf lists);
    ``scalars`` is a (3,) device row of :func:`adam_scalars`."""
    p, g = _leaves(params), list(grads)
    mu, nu = _leaves(mu), _leaves(nu)
    lr, bc1, bc2 = scalars[0], scalars[1], scalars[2]
    with torch.no_grad():
        torch._foreach_mul_(mu, ADAM_B1)
        torch._foreach_add_(mu, g, alpha=1.0 - ADAM_B1)
        torch._foreach_mul_(nu, ADAM_B2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - ADAM_B2)
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, ADAM_EPS)
        upd = torch._foreach_div(mu, bc1)
        torch._foreach_div_(upd, denom)
        torch._foreach_mul_(upd, lr)
        torch._foreach_sub_(p, upd)


def adam_update(params, grads, opt: AdamState, lr: float) -> AdamState:
    """One Adam step (:func:`adam_apply`) at learning rate ``lr``, in place
    on ``params`` and on the moments; -> the new state."""
    count = opt.count + 1
    scalars = adam_scalars([count], lr, _leaves(params)[0].device)
    adam_apply(params, grads, opt.mu, opt.nu, scalars[0])
    return AdamState(count, opt.mu, opt.nu)


def _state_tensors(state: TrainState) -> list:
    """The tensors of ``state`` that an epoch updates in place."""
    opt = state.opt_state
    return (_leaves(state.params) + _leaves(opt.mu) + _leaves(opt.nu)
            + _leaves(state.best_params) + [state.best_loss])


class _StepGraph:
    """An epoch's step captured as a CUDA graph, for one key and the
    tensors of one state: the input batches and Adam rows it reads, the
    log row it writes, and the side stream it warms up and captures on."""

    def __init__(self, key, state: TrainState, inputs, scalars):
        self.key, self.tensors = key, _state_tensors(state)
        self.inputs, self.scalars = inputs, scalars
        self.stream = torch.cuda.Stream(scalars.device)
        self.graph = self.out = None
        self.rows = 0  # rows ``autodiff.ops.value`` evaluates a replay

    def serves(self, key, state: TrainState) -> bool:
        tensors = _state_tensors(state)
        return key == self.key and len(tensors) == len(self.tensors) and all(
            a is b for a, b in zip(tensors, self.tensors))

    def warm_up(self, body):
        """``body()`` run eagerly on the side stream; -> its result."""
        cur = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            out = body()
        cur.wait_stream(self.stream)
        return out

    def capture(self, body):
        """Capture ``body()``; the work counter it advances is put back, as
        each replay advances it."""
        rows = autodiff_ops.value_rows
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=self.stream):
            self.out = body()
        self.rows, autodiff_ops.value_rows = autodiff_ops.value_rows - rows, rows

    def replay(self):
        self.graph.replay()
        autodiff_ops.value_rows += self.rows


def _flat(tensors) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


class Trainer:
    """Runs the epochs of one experiment on the sampler's device; with a
    ``group`` of several ranks, this rank's share of a data-parallel run
    (see the module docstring)."""

    def __init__(self, spec: SirenSpec, sampler: TrainingSampler, cfg: TrainConfig,
                 group: DataGroup | None = None):
        self.spec = spec
        self.sampler = sampler
        self.cfg = cfg
        self.device = sampler.device
        self.group = group if group is not None else single(sampler.device)
        self._vg_op, self._vgh_op = autograd_ops(spec)
        self._graph = None  # the graphed path's _StepGraph
        self.chunk_seconds = []  # (lo, hi, stage, seconds) per chunk of the last run
        self.last_swap_epoch = None  # the epoch the last run swapped samplers at
        # None on one rank; "sharded" (each rank its own sub-batch) or
        # "constrained" (each rank a block of one batch) on several
        self.dp = None
        if self.group.backend is not None:
            try:
                sampler.local(self.group.size)
                self.dp = "sharded"
            except ValueError as exc:
                warnings.warn(
                    f"{exc} — falling back to the constrained-sharding DP "
                    f"step (correct but slower; pick batch sizes whose "
                    f"[surf|far|near] groups divide the mesh for the fast "
                    f"path)", RuntimeWarning)
                self.dp = "constrained"
                rows = self.group.shard_rows(sampler.sizes.total)
                if rows.stop <= rows.start:
                    raise ValueError(f"a batch of {sampler.sizes.total} rows leaves rank "
                                     f"{self.group.rank} of {self.group.size} no rows")

    # --- state ---------------------------------------------------------------

    def init_state(self, key=None, params=None) -> TrainState:
        """``params`` (JAX layout, numpy or tensors) default to a SIREN init
        drawn from ``cfg.seed`` with numpy."""
        if key is None:
            key = key_from_seed(self.cfg.seed)
        if params is None:
            params = init_siren(self.spec, np.random.default_rng(self.cfg.seed))
        params = self.as_leaves(params)
        with torch.no_grad():  # every rank starts from rank 0's params
            for t in _leaves(params):
                self.group.broadcast(t)
        zeros = [{k: torch.zeros_like(v) for k, v in layer.items()} for layer in params]
        return TrainState(
            params=params,
            opt_state=AdamState(0, zeros, [{k: v.clone() for k, v in z.items()} for z in zeros]),
            best_loss=torch.tensor(float("inf"), device=self.device),
            best_params=[{k: v.detach().clone() for k, v in layer.items()} for layer in params],
            key=np.asarray(key, np.uint32),
        )

    def as_leaves(self, params):
        """JAX-layout params -> float32 leaf tensors on the device that
        require grad."""
        return [{k: torch.as_tensor(v, dtype=torch.float32, device=self.device)
                 .detach().clone().requires_grad_(True) for k, v in layer.items()}
                for layer in params]

    # --- stage plumbing ------------------------------------------------------

    def _loss_terms(self, stage, params, points, normals, sdf, n_surface):
        """Loss terms on this rank's rows; ``n_surface`` leading rows lie on
        the surface.  s2's statistics are summed over the group."""
        cfg = self.cfg
        if stage == "s1":
            return loss_s1(params, self.spec, points, normals, sdf,
                           cfg.loss_s1_weights, cfg.alpha, n_surface=n_surface,
                           vgh_fn=self._vgh_op, vg_fn=self._vg_op)
        if stage == "s2":
            group = self.group if self.group.backend is not None else None
            return loss_s2(params, self.spec, points, normals, sdf,
                           cfg.loss_s2_weights, cfg.alpha, group=group)
        if stage == "siren":
            return loss_siren(params, self.spec, points, normals, sdf, cfg.loss_weights)
        raise ValueError(stage)

    def lr(self, stage, epoch) -> float:
        cfg = self.cfg
        if stage == "siren":
            lr = lr_for_epoch_siren(epoch, warmup_epochs=cfg.warmup_epochs,
                                    warmup_lr=cfg.warmup_lr, lr=cfg.lr)
        else:
            lr = lr_for_epoch(
                epoch, num_epochs=cfg.num_epochs, s1_epochs=cfg.s1_epochs,
                warmup_epochs=cfg.warmup_epochs, warmup_lr=cfg.warmup_lr,
                lr_s1=cfg.lr_s1, lr_s2=cfg.lr_s2,
            )
        return float(lr)

    def stage_for_epoch(self, epoch: int) -> str:
        if self.cfg.gt_mode == "siren":
            return "siren"
        return "s1" if epoch < self.cfg.s1_epochs else "s2"

    def stage_boundaries(self):
        """Epoch indices where the loss changes."""
        if self.cfg.gt_mode == "siren":
            return []
        return [self.cfg.s1_epochs]

    # --- epochs --------------------------------------------------------------

    def draw(self, gen: torch.Generator):
        """This rank's rows of one batch -> (points, normals, sdf,
        n_surface, share): ``n_surface`` leading rows lie on the surface,
        and ``share`` is the rows' fraction of the whole batch."""
        sz = self.sampler.sizes
        if self.dp == "sharded":
            local = self.sampler.local(self.group.size)
            pts, nrm, sdf = local.sample(gen)
            return pts, nrm, sdf, local.sizes.on_surface, 1.0 / self.group.size
        pts, nrm, sdf = self.sampler.sample(gen)
        if self.dp == "constrained":
            rows = self.group.shard_rows(sz.total)
            n_rows = rows.stop - rows.start
            n_surface = min(max(sz.on_surface - rows.start, 0), n_rows)
            return pts[rows], nrm[rows], sdf[rows], n_surface, n_rows / sz.total
        return pts, nrm, sdf, sz.on_surface, 1.0

    def batch_step(self, stage, params, points, normals, sdf, n_surface, share=1.0):
        """Loss and gradient of one batch of which this rank holds the given
        rows -> (terms row (in ``TERM_NAMES`` order), their sum, grads):
        the terms of the whole batch and the gradient of their sum with
        respect to ``params``, the same on every rank."""
        parallel = self.group.backend is not None
        with span("train.loss"):
            terms = self._loss_terms(stage, params, points, normals, sdf, n_surface)
            row = torch.stack([terms[k] for k in TERM_NAMES[stage]])
            if parallel and stage != "s2":
                row = self.group.all_reduce_sum(row * share)
            total = row.sum()
        with span("train.backward"):
            grads = torch.autograd.grad(total, _leaves(params))
            if parallel:
                # the all-reduce's backward summed the gradient of the one
                # loss over the ranks: the sum over the ranks is size times it
                flat = self.group.all_reduce_sum(_flat(grads)) / self.group.size
                grads = torch.split(flat, [g.numel() for g in grads])
                grads = [g.view_as(p) for g, p in zip(grads, _leaves(params))]
        return row, total, grads

    def epoch(self, state: TrainState, stage: str, epoch: int, gen: torch.Generator):
        """Run one epoch in place on ``state``; -> its log row, a device
        tensor (terms..., total) summed over the batches, then epoch_loss.
        The epoch is the span ``train.epoch`` of step id ``epoch``, each
        batch a ``train.step`` of ``train.draw``, ``train.loss``,
        ``train.backward`` and ``train.adam`` (:mod:`..utils.timing`).  On
        the graphed path (module docstring) each ``train.step`` holds its
        draw alone, and one ``train.replay`` after them the copies into the
        graph's inputs and the replay."""
        global surface_rows, eager_steps
        timing.set_step(epoch)
        with span("train.epoch"):
            lr = self.lr(stage, epoch)
            if self._graphable(stage):
                return self._graph_epoch(state, stage, gen, lr)
            eager_steps += 1
            sums = self._zero_sums(stage)
            for _ in range(self.cfg.batches_per_epoch):
                with span("train.step"):
                    with span("train.draw"):
                        batch = self.draw(gen)
                    surface_rows += batch[3]
                    row, total, grads = self.batch_step(stage, state.params, *batch)
                    with span("train.adam"):
                        state.opt_state = adam_update(state.params, grads, state.opt_state, lr)
                sums += torch.cat([row, total[None]]).detach()
            return self._epoch_end(state, sums)

    def _zero_sums(self, stage):
        return torch.zeros(len(TERM_NAMES[stage]) + 1, device=self.device)

    def _epoch_end(self, state: TrainState, sums):
        """The best loss and params, in place; -> the epoch's log row."""
        epoch_loss = sums[-1] / self.cfg.batches_per_epoch
        # the JAX package's quirk, kept: the params chosen are those
        # AFTER this epoch's updates, on the loss measured before them
        is_best = epoch_loss < state.best_loss
        with torch.no_grad():
            state.best_loss.copy_(torch.where(is_best, epoch_loss, state.best_loss))
            for new, old in zip(_leaves(state.params), _leaves(state.best_params)):
                old.copy_(torch.where(is_best, new, old))
        return torch.cat([sums, epoch_loss[None]])

    # --- the epoch as a CUDA graph --------------------------------------------

    def _graphable(self, stage: str) -> bool:
        """Whether the epoch runs on the graphed path: one CUDA device, no
        process group, and a stage whose step counts nothing in Python at
        call time (s1's kernels count their launches)."""
        return (self.device.type == "cuda" and self.group.backend is None
                and stage != "s1")

    def _graph_body(self, stage, state: TrainState, inputs, scalars):
        """The epoch after its draws, on the batches ``inputs`` with the Adam
        rows ``scalars`` (:func:`adam_scalars`): what the graph captures.
        -> the epoch's log row."""
        sums = self._zero_sums(stage)
        for k, batch in enumerate(inputs):
            row, total, grads = self.batch_step(stage, state.params, *batch)
            with span("train.adam"):
                adam_apply(state.params, grads, state.opt_state.mu, state.opt_state.nu,
                           scalars[k])
            sums += torch.cat([row, total[None]]).detach()
        return self._epoch_end(state, sums)

    def _graph_epoch(self, state: TrainState, stage, gen, lr):
        """One epoch on the graphed path: the eager draws, then their copies
        into the graph's inputs and the graph (the module docstring)."""
        global surface_rows, eager_steps, graph_captures, graph_replays
        batches = []
        for _ in range(self.cfg.batches_per_epoch):
            with span("train.step"):
                with span("train.draw"):
                    batch = self.draw(gen)
                surface_rows += batch[3]
            batches.append(batch)
        opt = state.opt_state
        counts = range(opt.count + 1, opt.count + 1 + len(batches))
        state.opt_state = AdamState(opt.count + len(batches), opt.mu, opt.nu)
        key = (stage, torch.backends.cuda.matmul.allow_tf32,
               tuple(tuple(t.shape for t in b[:3]) + tuple(b[3:]) for b in batches))
        g = self._graph
        if g is None or not g.serves(key, state):
            # a new key: the step runs eagerly once, on the side stream that
            # captures it at the next epoch
            eager_steps += 1
            inputs = [tuple(t.clone() for t in b[:3]) + tuple(b[3:]) for b in batches]
            g = self._graph = _StepGraph(key, state, inputs,
                                         adam_scalars(counts, lr, self.device))
            return g.warm_up(lambda: self._graph_body(stage, state, g.inputs, g.scalars))
        with span("train.replay"):
            for dst, b in zip(g.inputs, batches):
                for d, t in zip(dst[:3], b[:3]):
                    d.copy_(t)
            adam_scalars(counts, lr, self.device, out=g.scalars)
            if g.graph is None:
                g.capture(lambda: self._graph_body(stage, state, g.inputs, g.scalars))
                graph_captures += 1
            else:
                graph_replays += 1
            g.replay()
        return g.out.clone()

    def chunk_edges(self, start_epoch: int, chunk_size: int):
        """(lo, hi) epoch ranges: chunks of up to ``chunk_size`` (or the
        checkpoint cadence, if shorter), cut at stage boundaries and at
        checkpoint epochs."""
        cfg = self.cfg
        if 0 < cfg.epochs_to_checkpoint < chunk_size:
            chunk_size = cfg.epochs_to_checkpoint
        marks = {cfg.num_epochs}
        for b in self.stage_boundaries():
            if start_epoch < b < cfg.num_epochs:
                marks.add(b)
        if cfg.epochs_to_checkpoint:
            marks.update(range(cfg.epochs_to_checkpoint, cfg.num_epochs,
                               cfg.epochs_to_checkpoint))
        e, edges = start_epoch, []
        while e < cfg.num_epochs:
            nxt = min([m for m in marks if m > e] + [e + chunk_size])
            edges.append((e, nxt))
            e = nxt
        return edges

    def run(self, state: TrainState | None = None, start_epoch: int = 0,
            chunk_size: int = 250, callback=None, sampler_update=None):
        """Train from ``start_epoch`` to ``num_epochs``.

        ``callback(epoch_end, state, logs)`` fires after every chunk;
        ``logs`` maps term name -> np array of per-epoch values within the
        chunk (plus ``total``, ``lr`` and ``epoch_loss``).

        ``sampler_update()`` (optional) is polled before every epoch until
        it returns a sampler (the handover of a background oracle build,
        :mod:`..data.async_build`).  Training goes on with that sampler from
        the first epoch at which every rank of the group holds one (an
        all-reduce of the flag; at once on a single device), so the swap
        lands at the same epoch on every rank, and a rank whose build failed
        keeps every rank on the bootstrap oracle.  ``self.last_swap_epoch``
        records the epoch.  The JAX trainer polls once a chunk, because its
        chunk is one compiled scan; here an epoch is a Python call and the
        poll reads a flag.  The batches come from the same generator stream
        either way.

        Returns (final_state, losses dict of full-length np arrays,
        training_seconds: chunk time with the device synchronised at each
        chunk's end, callback work excluded).  ``self.chunk_seconds`` keeps
        each chunk's (lo, hi, stage, seconds).
        """
        if state is None:
            state = self.init_state()
        self.callback_seconds = 0.0
        self.chunk_seconds = []
        self.last_swap_epoch = None
        all_logs, train_time, pending = [], 0.0, None
        for lo, hi in self.chunk_edges(start_epoch, chunk_size):
            stage = self.stage_for_epoch(lo)
            names = TERM_NAMES[stage] + ("total", "epoch_loss")
            t0 = time.perf_counter()
            key = rank_key(state.key, self.group.rank) if self.dp == "sharded" else state.key
            gen = generator_for(key, self.device)
            state.key = next_key(state.key)
            rows = []
            for e in range(lo, hi):
                if sampler_update is not None:
                    if pending is None:
                        pending = sampler_update()
                    if self.group.all_true(pending is not None):
                        self.sampler, self.last_swap_epoch = pending, e
                        sampler_update = None  # one handover, on every rank
                rows.append(self.epoch(state, stage, e, gen))
            table = torch.stack(rows).cpu().numpy()  # the chunk's one host read
            secs = time.perf_counter() - t0
            train_time += secs
            self.chunk_seconds.append((lo, hi, stage, secs))
            logs = {k: table[:, i].astype(np.float64) for i, k in enumerate(names)}
            logs["lr"] = np.array([self.lr(stage, e) for e in range(lo, hi)])
            all_logs.append((lo, hi, logs))
            if callback is not None:
                t_cb = time.perf_counter()
                callback(hi, state, logs)
                self.callback_seconds += time.perf_counter() - t_cb

        self._graph = None  # its memory pool goes with it
        keys = sorted({k for _, _, lg in all_logs for k in lg})
        losses = {k: np.full(self.cfg.num_epochs - start_epoch, np.nan) for k in keys}
        for lo, hi, lg in all_logs:
            for k, v in lg.items():
                losses[k][lo - start_epoch:hi - start_epoch] = v
        return state, losses, train_time

