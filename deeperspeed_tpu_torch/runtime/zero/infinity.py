"""ZeRO-Infinity: train a model whose parameters exceed the device budget
(counterpart of ``deeperspeed_tpu/runtime/zero/infinity.py``).

Every tensor of persistent state -- the compute-dtype parameters, the fp32
masters and the Adam moments -- lives on disk between uses, written and
read through the native aio pool (``ops/aio``); the device holds one unit
of the model at a time.  The units are cut from the port's flat model
(``GPTNeoX`` or ``Llama``; a stage model, ``GPTNeoXPipe`` or ``LlamaPipe``,
streams the flat model it cuts, in ``num_stages`` chunks, as the JAX engine
chunks a stacked stage model): ``embed`` (the input embedding, and OPT's
positions), the block list in ``num_chunks`` contiguous groups
``c0 .. c{n-1}``, and ``head`` (the final norm and the output projection).
Tied embeddings are refused, as ``LlamaPipe`` refuses them.  Each unit's
parameters are one flat buffer a kind (``bf16``, the compute copy;
``master``; ``mu``; ``nu``; ``grad``, the accumulation), one file each.

* **forward**: each unit's compute copy is read from disk (the next unit's
  read is in flight meanwhile), copied to the device, run without autograd,
  and dropped; only each chunk's input (its boundary activation) is kept.
* **backward**: the chunks in reverse, each re-running its forward under
  autograd from its saved input (the model's flash attention K5-K7 and
  LayerNorm K1/K8 run here on the card), which gives the chunk's gradients
  and the cotangent of its input, which flows to the chunk before it.
* **update**: a unit's gradients come down to the host in one copy; its
  masters and moments are read (the moments start at zero, on disk from
  the unit's first update on), the native CPU Adam
  (``ops/adam/cpu_adam.py``) updates them in place, and they are written
  back with the refreshed compute copy: the device never holds optimizer
  state, and the host holds one unit's.

``gradient_accumulation_steps`` > 1 accumulates each micro's gradients in
fp32 buffers on disk, weighted by the micro's loss-mask tokens, and the
last micro's update applies their mean.  ``peak_device_param_bytes`` is
the ledger of the parameter bytes resident on the device: a unit's bytes
are dropped only after the kernels that read it have finished (the device
is synchronized first), so the peak is a true bound.  ``swap_stats``
reports the disk traffic.  The native libraries are required: without
them the engine raises.

``memory_schedule``: ``static`` and ``off`` stream every unit with one
disk read ahead (``static`` with ``hbm_budget_bytes`` checks two units
against it, ``comm.memplan.assert_hbm_fit``).  ``auto`` runs
``comm.memplan.plan_chunk_stream`` over the units' bytes, against the
budget, the calibration's per-unit compute time and the host link
(``h2d_bytes_per_s``, else the calibration's, else ``telemetry/wire.py``'s
figure for the card): the planned **resident** units are copied to the
card once, kept across steps (refreshed in place after their update) and
cost the ledger nothing at release; the others stream through an
**issue-ahead window** of up to ``prefetch_depth`` copies to the card in
flight, each issued from its pinned host buffer on a side CUDA stream and
waited for (its event) on the compute stream before its unit runs; the
ledger counts a copy from its issue, and the step fails if the ledger
passes the plan's ``peak_bytes``.  The plan moves *when* bytes move:
losses and masters are the static schedule's, bit for bit.
"""

import os
import shutil
import tempfile
import time
import weakref

import torch

from ...accelerator import resolve_device
from ...utils.logging import log_dist


class _ChunkStore:
    """Flat tensors on disk keyed by (kind, unit), through the aio pool;
    one read in flight at a time (:meth:`prefetch`, then :meth:`get`)."""

    def __init__(self, swap_dir, num_threads=4, pin=False):
        from ...ops.aio import AsyncIOHandle

        os.makedirs(swap_dir, exist_ok=True)
        self.dir = tempfile.mkdtemp(prefix="zinf_", dir=swap_dir)
        self._cleanup = weakref.finalize(self, shutil.rmtree, self.dir, ignore_errors=True)
        self._handle = AsyncIOHandle(num_threads)
        self._pin = pin
        self._meta = {}          # (kind, unit) -> (path, numel, dtype)
        self._pending = None     # (key, buffer) of the read in flight
        self.bytes_read = 0
        self.bytes_written = 0
        self.io_wait_s = 0.0

    def _wait(self):
        t0 = time.perf_counter()
        rc = self._handle.wait()
        self.io_wait_s += time.perf_counter() - t0
        if rc != 0:
            raise OSError(-rc, f"ZeRO-Infinity swap IO failed: {os.strerror(-rc)}")

    def write(self, kind, unit, flat):
        """Submit an fsync'd write of ``flat`` (a contiguous CPU tensor, kept
        alive by the pool until the next wait)."""
        path = os.path.join(self.dir, f"{kind}_{unit}.bin")
        self._handle.async_pwrite(flat, path, fsync=True)
        self._meta[(kind, unit)] = (path, flat.numel(), flat.dtype)
        self.bytes_written += flat.numel() * flat.element_size()

    def has(self, kind, unit):
        """Whether (kind, unit) was written."""
        return (kind, unit) in self._meta

    def prefetch(self, kind, unit):
        """Start reading (kind, unit) into a new (pinned) buffer; the writes
        submitted before are waited for first, so the read sees them."""
        if self._pending is not None:
            raise RuntimeError("one prefetch in flight at a time")
        path, n, dtype = self._meta[(kind, unit)]
        self._wait()
        buf = torch.empty(n, dtype=dtype, pin_memory=self._pin)
        self._handle.async_pread(buf, path)
        self.bytes_read += n * buf.element_size()
        self._pending = ((kind, unit), buf)

    def get(self, kind, unit):
        """(kind, unit)'s tensor: the prefetch's, or read now; a prefetch of
        another key is waited for and dropped."""
        if self._pending is not None and self._pending[0] != (kind, unit):
            self._wait()
            self._pending = None
        if self._pending is None:
            self.prefetch(kind, unit)
        _, buf = self._pending
        self._pending = None
        self._wait()
        return buf

    def drain(self):
        self._wait()

    def close(self):
        if self._handle is not None:
            self._handle.close()
            self._handle = None
        self._cleanup()


def _family(model):
    """The units' modules and the three pieces of the forward of a port
    model: (embed modules, blocks, head modules, embed(x), head(x))."""
    from ...models.gpt_neox import GPTNeoX
    from ...models.llama import Llama

    if isinstance(model, GPTNeoX):
        cfg = model.config
        return ([model.embed_in], list(model.layers),
                [model.final_layer_norm, model.embed_out],
                lambda ids, pos: model.embed_in(ids).to(cfg.dtype),
                lambda x: model.embed_out(model.final_layer_norm(x)))
    if isinstance(model, Llama):
        cfg = model.config
        if cfg.tie_embeddings:
            # the JAX engine streams LlamaPipe, which refuses tied embeddings
            raise NotImplementedError(
                "tie_embeddings under the chunk stream is not supported: the tied table "
                "would have to live in both the first and the last unit")

        def embed(ids, pos):
            x = model.embed_tokens(ids).to(cfg.dtype)
            if cfg.learned_positions:
                x = x + model.embed_positions(pos).to(cfg.dtype)
            return x

        emb = [model.embed_tokens] + ([model.embed_positions] if cfg.learned_positions
                                      else [])
        return (emb, list(model.layers), [model.final_norm, model.lm_head], embed,
                lambda x: model.lm_head(model.final_norm(x)))
    raise TypeError(f"ZeroInfinityEngine streams GPTNeoX or Llama, not {type(model).__name__}")


def _loss(logits, labels, mask):
    """Mean next-token cross entropy over fp32 logits where ``mask`` is set
    (the models' ``loss_fn``)."""
    logits = logits.to(torch.float32)
    token_ll = (torch.gather(logits, -1, labels[..., None])[..., 0]
                - torch.logsumexp(logits, dim=-1))
    return -(token_ll * mask).sum() / mask.sum().clamp(min=1.0)


class _Unit:
    """One streamed unit: its parameters, in order, and their offsets in
    the unit's flat buffers."""

    def __init__(self, name, modules):
        self.name = name
        self.params = [p for m in modules for p in m.parameters()]
        self.shapes = [tuple(p.shape) for p in self.params]
        self.sizes = [p.numel() for p in self.params]
        self.offsets, n = [], 0
        for size in self.sizes:
            self.offsets.append(n)
            n += size
        self.numel = n

    def views(self, flat):
        return [flat[o:o + n].view(s) for o, n, s in zip(self.offsets, self.sizes, self.shapes)]


class ZeroInfinityEngine:
    """The chunk-streaming trainer over a port ``GPTNeoX`` or ``Llama`` in
    ``num_chunks`` chunks (2 by default), or over a stage model
    (``GPTNeoXPipe``, ``LlamaPipe``) in ``num_stages`` chunks, each a
    stage's blocks, with no pipeline processes (the JAX
    ``ZeroInfinityEngine`` streams the stacked stage model so).

    ``params``: initial weights (name -> tensor, the flat model's state
    dict, for a stage model too), else the model's own.  ``device``: CUDA
    unless ``"cpu"``."""

    def __init__(self, model, nvme_path, num_chunks=None, lr=1e-3, betas=(0.9, 0.999),
                 eps=1e-8, weight_decay=0.0, compute_dtype=torch.bfloat16, swap_threads=4,
                 memory_schedule="static", hbm_budget_bytes=None, params=None, device=None,
                 h2d_bytes_per_s=None, calibration=None):
        from ...ops.adam.cpu_adam import DeeperSpeedCPUAdam

        if memory_schedule not in ("auto", "static", "off"):
            raise ValueError(f"memory_schedule must be auto|static|off, got {memory_schedule!r}")
        self.device = resolve_device(device)
        if hasattr(model, "build_stage"):
            if num_chunks not in (None, model.num_stages):
                raise ValueError(f"a stage model streams in its {model.num_stages} stages, "
                                 f"not {num_chunks} chunks")
            # its stages are the flat model's modules drawn from the same
            # seed (``build_stage``): stream that model, a stage a chunk
            kw = {"draw_on_device": True} if getattr(model, "draw_on_device", False) else {}
            num_chunks, model = model.num_stages, model.FLAT(
                model.config, device=model.device, seed=model.seed, **kw)
        num_chunks = 2 if num_chunks is None else num_chunks
        self.model = model
        self.compute_dtype = compute_dtype
        self.memory_schedule = memory_schedule
        self.hbm_budget_bytes = hbm_budget_bytes
        self._pin = self.device.type == "cuda"
        self._adam = DeeperSpeedCPUAdam(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay)
        self.step_count = 0
        self.peak_device_param_bytes = 0
        self._resident_bytes = 0
        self.mem_plan = None
        self._resident = {}        # planned-resident units: name -> (device buffer, bytes)
        self._h2d_inflight = {}    # issue-ahead copies: name -> (host, device, bytes, event)
        self._copy_stream = None   # the side stream of the issue-ahead copies

        emb, blocks, head, self._embed, self._head = _family(model)
        if not 1 <= num_chunks <= len(blocks):
            raise ValueError(f"num_chunks {num_chunks} for {len(blocks)} blocks")
        self.chunks = num_chunks
        bounds = [round(i * len(blocks) / num_chunks) for i in range(num_chunks + 1)]
        self.units = {"embed": _Unit("embed", emb)}
        for c in range(num_chunks):
            self.units[f"c{c}"] = _Unit(f"c{c}", blocks[bounds[c]:bounds[c + 1]])
        self.units["head"] = _Unit("head", head)
        self._blocks = {f"c{c}": blocks[bounds[c]:bounds[c + 1]] for c in range(num_chunks)}
        # the plan (or the static budget check) before anything is written;
        # the units in the JAX engine's order (the chunks, embed, head): the
        # planner sums their transfer times in it
        itemsize = torch.empty(0, dtype=compute_dtype).element_size()
        order = [f"c{c}" for c in range(num_chunks)] + ["embed", "head"]
        self._unit_bytes = {n: self.units[n].numel * itemsize for n in order}
        self.total_param_bytes = sum(self._unit_bytes.values())
        self._plan_memory(calibration, h2d_bytes_per_s)

        # every unit's masters and compute copy to disk, one unit at a time
        # (the pool holds the buffers until its wait); the moments start at
        # zero and reach the disk at the unit's first update
        self.store = _ChunkStore(nvme_path, num_threads=swap_threads, pin=self._pin)
        names = {id(p): n for n, p in model.named_parameters()}
        given = params
        for unit in self.units.values():
            master = torch.empty(unit.numel, dtype=torch.float32, pin_memory=self._pin)
            for p, view in zip(unit.params, unit.views(master)):
                src = p.detach() if given is None else torch.as_tensor(given[names[id(p)]])
                view.copy_(src.reshape(view.shape))
            self.store.write("master", unit.name, master)
            self.store.write("bf16", unit.name, master.to(compute_dtype))
            self.store.drain()
            for p in unit.params:
                p.data = torch.empty(0, dtype=compute_dtype, device=self.device)
        log_dist(f"ZeroInfinityEngine: {num_chunks} chunks | compute "
                 f"{str(compute_dtype).split('.')[-1]} on {self.device}, fp32 masters + "
                 f"moments on disk ({self.store.dir})"
                 + (f" | {self.mem_plan.tag}" if self.mem_plan else ""), ranks=[0])

    def _plan_memory(self, calibration, h2d_bytes_per_s):
        """The stream's plan (the JAX engine's ``_plan_memory``): ``auto``
        runs ``plan_chunk_stream`` over the unit bytes, with the per-unit
        compute time of the calibration (``calibration=``, else
        ``DST_TUNER_CACHE``'s) and its host-link rate unless
        ``h2d_bytes_per_s`` is given; ``static`` with a budget checks the
        unit in use plus one read ahead against it."""
        from ...comm import memplan

        if self.memory_schedule == "off":
            return
        if self.memory_schedule == "static":
            if self.hbm_budget_bytes:
                memplan.assert_hbm_fit("zero-infinity static chunk stream",
                                       2 * max(self._unit_bytes.values()),
                                       self.hbm_budget_bytes)
            return
        cal = calibration if calibration is not None else memplan.load_calibration()
        compute_s_per_chunk = None
        if cal is not None:
            if cal.compute_s > 0:
                compute_s_per_chunk = cal.compute_s / max(len(self._unit_bytes), 1)
            if h2d_bytes_per_s is None:
                h2d_bytes_per_s = cal.h2d_bytes_per_s
        # working_bytes=0: the plan bounds parameter residency, the same
        # thing the peak_device_param_bytes ledger tracks
        self.mem_plan = memplan.plan_chunk_stream(
            self._unit_bytes, hbm_budget_bytes=self.hbm_budget_bytes,
            compute_s_per_chunk=compute_s_per_chunk, h2d_bytes_per_s=h2d_bytes_per_s,
            device_kind=memplan.device_kind_of(self.device))

    # ------------------------------------------------------------- residency
    def _ledger_add(self, nbytes):
        self._resident_bytes += nbytes
        self.peak_device_param_bytes = max(self.peak_device_param_bytes, self._resident_bytes)

    def _device_copy(self, name):
        """Unit ``name``'s compute copy on the device: ``(host, device,
        bytes)``, the ledger counting it from here."""
        host = self.store.get("bf16", name)
        dev = host.to(self.device, non_blocking=True)
        nbytes = dev.numel() * dev.element_size()
        self._ledger_add(nbytes)
        return host, dev, nbytes

    def _fetch(self, name, grad=False):
        """Unit ``name``'s compute copy on the device -- the planned resident
        copy, the issue-ahead copy in flight, or one streamed now -- its
        parameters bound to it; with ``grad``, their gradients land in one
        flat buffer."""
        unit = self.units[name]
        if self.mem_plan is not None and name in self.mem_plan.resident:
            if name not in self._resident:
                host, dev, nbytes = self._device_copy(name)
                self._resident[name] = (dev, nbytes)
            # bytes 0: the resident copy stays, its release frees nothing
            host, dev, nbytes = None, self._resident[name][0], 0
        elif name in self._h2d_inflight:
            host, dev, nbytes, event = self._h2d_inflight.pop(name)
            if event is not None:
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(event)
                dev.record_stream(stream)
        else:
            host, dev, nbytes = self._device_copy(name)
        gflat = torch.zeros_like(dev) if grad else None
        for p, view, gview in zip(unit.params, unit.views(dev),
                                  unit.views(gflat) if grad else [None] * len(unit.params)):
            p.data = view
            p.grad = gview
            p.requires_grad_(grad)
        return (host, dev, nbytes), gflat

    def _release(self, name, held):
        """Drop unit ``name`` from the device once the kernels that read it
        have finished (the ledger is a true bound; a resident unit's copy
        stays, and its bytes with it)."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        for p in self.units[name].params:
            p.data = torch.empty(0, dtype=self.compute_dtype, device=self.device)
            p.grad = None
        self._resident_bytes -= held[2]

    def _prefetch_next(self, upcoming):
        """Overlap the next units' fetch with the current compute
        (``upcoming``: the units the step uses next, in order).  Static and
        off: one disk read in flight for ``upcoming[0]``, copied to the card
        at its use.  Auto: the issue-ahead window -- up to the plan's
        ``prefetch_depth`` copies to the card in flight, each read from disk
        here and issued from its pinned buffer on the side stream, the
        ledger counting it from now."""
        if not upcoming:
            return
        if self.mem_plan is None:
            self.store.prefetch("bf16", upcoming[0])
            return
        for name in upcoming:
            if len(self._h2d_inflight) >= self.mem_plan.prefetch_depth:
                break
            if name in self.mem_plan.resident or name in self._h2d_inflight:
                continue
            host = self.store.get("bf16", name)
            event = None
            if self.device.type == "cuda":
                if self._copy_stream is None:
                    self._copy_stream = torch.cuda.Stream(self.device)
                with torch.cuda.stream(self._copy_stream):
                    dev = host.to(self.device, non_blocking=True)
                    event = torch.cuda.Event()
                    event.record(self._copy_stream)
            else:
                dev = host.to(self.device)
            nbytes = dev.numel() * dev.element_size()
            self._ledger_add(nbytes)
            self._h2d_inflight[name] = (host, dev, nbytes, event)

    def _flush_inflight(self):
        """Drop the issue-ahead copies nobody consumed (the windows cover
        exactly the uses ahead, so normally none), so that a copy from
        before an update can never feed a later step."""
        for _, _, nbytes, _ in self._h2d_inflight.values():
            self._resident_bytes -= nbytes
        self._h2d_inflight.clear()

    # ------------------------------------------------------------ train step
    def train_batch(self, batch, gradient_accumulation_steps=1):
        """One optimizer step over ``batch`` (``input_ids``, ``labels``,
        optionally ``loss_mask``); returns the loss, the token-weighted mean
        of the micros' losses."""
        gas = gradient_accumulation_steps
        ids_all = torch.as_tensor(batch["input_ids"]).long()
        labels_all = torch.as_tensor(batch["labels"]).long()
        mask_all = batch.get("loss_mask")
        mask_all = (torch.ones(labels_all.shape) if mask_all is None
                    else torch.as_tensor(mask_all)).to(torch.float32)
        if ids_all.shape[0] % gas:
            raise ValueError(f"batch dim {ids_all.shape[0]} not divisible by gas={gas}")
        mb = ids_all.shape[0] // gas
        self.step_count += 1          # every unit's Adam below shares this step
        chunks = [f"c{c}" for c in range(self.chunks)]
        fwd_names, bwd_names = chunks + ["head"], chunks[::-1] + ["embed"]
        msums = [float(mask_all[m * mb:(m + 1) * mb].sum()) for m in range(gas)]
        total = max(sum(msums), 1.0)
        losses = []
        for m in range(gas):
            sl = slice(m * mb, (m + 1) * mb)
            ids, labels, mask = (t[sl].to(self.device) for t in (ids_all, labels_all, mask_all))
            pos = torch.arange(ids.shape[1], device=self.device).expand_as(ids)

            def consume(name, gflat):
                """The unit's gradients: its direct update (gas 1), added to
                the fp32 accumulation on disk, or (the last micro) added and
                the mean applied."""
                g = gflat.to("cpu", torch.float32)
                if gas == 1:
                    self._update_unit(name, g)
                    return
                g.mul_(msums[m])
                if m > 0:
                    g.add_(self.store.get("grad", name))
                if m == gas - 1:
                    self._update_unit(name, g.mul_(1.0 / total))
                else:
                    self.store.write("grad", name, g)

            # forward sweep: stream the units, keep each chunk's input
            with torch.no_grad():
                held, _ = self._fetch("embed")
                x = self._embed(ids, pos)
                self._release("embed", held)
                saved = []
                self._prefetch_next(fwd_names + bwd_names)
                for i, name in enumerate(chunks):
                    held, _ = self._fetch(name)
                    saved.append(x)
                    for blk in self._blocks[name]:
                        x = blk(x, pos)
                    self._prefetch_next(fwd_names[i + 1:] + bwd_names)
                    self._release(name, held)

            # the head: the loss and the cotangent of its input
            held, gflat = self._fetch("head", grad=True)
            x_in = x.detach().requires_grad_(True)
            loss = _loss(self._head(x_in), labels, mask)
            loss.backward()
            dy = x_in.grad
            self._release("head", held)
            consume("head", gflat)

            # backward sweep: each chunk's forward again under autograd; the
            # next unit's read starts after the update's reads and writes
            self._prefetch_next(bwd_names)
            for i, name in enumerate(chunks[::-1]):
                held, gflat = self._fetch(name, grad=True)
                x_in = saved.pop().detach().requires_grad_(True)
                y = x_in
                for blk in self._blocks[name]:
                    y = blk(y, pos)
                y.backward(dy.to(y.dtype))
                dy = x_in.grad
                self._release(name, held)
                consume(name, gflat)
                self._prefetch_next(bwd_names[i + 1:])

            # the embedding's backward
            held, gflat = self._fetch("embed", grad=True)
            self._embed(ids, pos).backward(dy)
            self._release("embed", held)
            consume("embed", gflat)
            losses.append(float(loss.detach()))
        if self.mem_plan is not None:
            self._flush_inflight()
            if self.peak_device_param_bytes > self.mem_plan.peak_bytes:
                raise AssertionError(
                    f"planned peak violated: the ledger saw {self.peak_device_param_bytes} "
                    f"device parameter bytes, the plan bounds them at "
                    f"{self.mem_plan.peak_bytes} ({self.mem_plan.describe()})")
        return sum(l * w for l, w in zip(losses, msums)) / total

    def _update_unit(self, name, grad):
        """The native Adam on one unit: its masters and moments in, updated
        in place, written back with the refreshed compute copy."""
        master = self.store.get("master", name)
        mu, nu = (self.store.get(kind, name) if self.store.has(kind, name)
                  else torch.zeros(master.numel(), dtype=torch.float32) for kind in ("mu", "nu"))
        # every unit takes the same step: pin t (step() adds one)
        self._adam.t = self.step_count - 1
        self._adam._moments = {name: (mu, nu)}
        self._adam.step({name: master}, {name: grad})
        self.store.write("master", name, master)
        self.store.write("mu", name, mu)
        self.store.write("nu", name, nu)
        compute = master.to(self.compute_dtype)
        self.store.write("bf16", name, compute)
        if name in self._h2d_inflight:
            # a copy of the bytes before the update is stale (the windows
            # never span an update; dropped all the same)
            self._resident_bytes -= self._h2d_inflight.pop(name)[2]
        if name in self._resident:
            # the resident copy refreshed in place: same bytes, ledger as is
            # (the unit's kernels finished at its release)
            self._resident[name][0].copy_(compute)

    def master(self, name):
        """Unit ``name``'s fp32 masters by parameter, read from disk."""
        unit = self.units[name]
        return [v.clone() for v in unit.views(self.store.get("master", name))]

    # ------------------------------------------------------------- reporting
    @property
    def swap_stats(self):
        s = self.store
        wall = max(s.io_wait_s, 1e-9)
        stats = {
            "bytes_read": s.bytes_read,
            "bytes_written": s.bytes_written,
            "io_wait_s": round(s.io_wait_s, 4),
            "waited_bandwidth_gbps": round((s.bytes_read + s.bytes_written) / wall / 1e9, 3),
            "peak_device_param_bytes": self.peak_device_param_bytes,
            "total_param_bytes": self.total_param_bytes,
            "memory_schedule": self.memory_schedule,
            "resident_set_bytes": sum(b for _, b in self._resident.values()),
        }
        if self.mem_plan is not None:
            stats["planned_peak_bound"] = self.mem_plan.peak_bytes
            stats["planned_prefetch_depth"] = self.mem_plan.prefetch_depth
        return stats

    def close(self):
        self.store.close()
