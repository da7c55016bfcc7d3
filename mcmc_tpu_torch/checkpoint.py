"""Checkpoint / resume (PyTorch port of ``mcmc_tpu.checkpoint``).

The reference has no resume capability: a run is one synchronous call with
all state in stack locals (SURVEY.md §5). Here the full sampler state — a
tree of tensors and host counters (named tuples, tuples, lists, dicts),
adaptation statistics and draw buffers included — and the run's
``torch.Generator`` state serialize to one file, and :class:`ChunkedRunner`
executes any transition kernel in restartable chunks, streaming kept draws
to a :class:`mcmc_tpu_torch.runtime.DrawSink` so a killed job resumes
bit-exactly from the last completed chunk.

One generator drives a whole run (the JAX package splits a key per chain
and per draw); the runner makes the same ``step(gen, state)`` calls in the
same order as the in-memory loop, so a checkpointed run equals the
in-memory run with the same seed bit for bit, and the JAX runner's
``single_key`` switch (per-chain keys or one key per draw) has no
counterpart: every kernel is a whole-batch step on one generator. The
generator's state is part of each checkpoint (``get_state()``: the
mt19937 state on the CPU, the seed and offset on the card).
"""

from __future__ import annotations

import contextlib
import json
import os
import pathlib
import sys
import tempfile
import time
import warnings

import numpy as np
import torch
import torch.distributed as dist

from mcmc_tpu_torch.runtime import DrawSink, read_draws

__all__ = ["save", "restore", "ChunkedRunner"]


# ---------------------------------------------------------------------------
# trees of tensors and host values
# ---------------------------------------------------------------------------

def _flatten(tree):
    """Leaves of ``tree`` in a fixed order: tensors, numpy arrays, Python
    numbers and ``torch.Generator``s, inside named tuples, tuples, lists
    and dicts (``None`` is structure, not a leaf)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _flatten(v)]
    return [tree]


def _unflatten(like, leaves):
    """A tree of ``like``'s structure with the leaves taken in order from
    the iterator ``leaves``."""
    if like is None:
        return None
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(v, leaves) for v in like))
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def _to_numpy(leaf):
    if isinstance(leaf, torch.Generator):
        return leaf.get_state().numpy()
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _from_numpy(tmpl, arr):
    """A leaf like ``tmpl`` from its saved array: a tensor on ``tmpl``'s
    device and dtype, a host number of ``tmpl``'s type, or ``tmpl`` itself
    (a generator) with its state set. Raises ``ValueError`` on a shape
    mismatch."""
    if isinstance(tmpl, torch.Generator):
        tmpl.set_state(torch.from_numpy(np.array(arr, np.uint8)))
        return tmpl
    if torch.is_tensor(tmpl):
        if tuple(arr.shape) != tuple(tmpl.shape):
            raise ValueError(f"checkpoint leaf has shape {arr.shape}, "
                             f"template {tuple(tmpl.shape)}")
        return torch.from_numpy(np.array(arr)).to(device=tmpl.device,
                                                   dtype=tmpl.dtype)
    if isinstance(tmpl, np.ndarray):
        return np.array(arr, dtype=tmpl.dtype)
    if arr.shape != ():
        raise ValueError(f"checkpoint leaf has shape {arr.shape}, template "
                         f"is a number")
    return type(tmpl)(arr.item())


def _write_npz(path, arrays, payload):
    """Atomically write ``arrays`` and the JSON ``payload`` to ``path``
    (a temporary file in the same directory, then a rename); no pickle."""
    path = pathlib.Path(path)
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, __meta__=json.dumps(payload), **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def save(path, tree):
    """Atomically serialize a tree of tensors, arrays, host numbers and
    generators to ``path``."""
    leaves = [_to_numpy(x) for x in _flatten(tree)]
    _write_npz(path, {f"leaf_{i}": a for i, a in enumerate(leaves)},
               {"n_leaves": len(leaves)})


def restore(path, like):
    """Restore a tree saved by :func:`save`. ``like`` supplies the
    structure, each tensor's device and dtype and each number's type;
    generators in ``like`` get their saved state."""
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        leaves = [data[f"leaf_{i}"] for i in range(meta["n_leaves"])]
    tmpl = _flatten(like)
    if len(tmpl) != len(leaves):
        raise ValueError(f"checkpoint has {len(leaves)} leaves, template "
                         f"has {len(tmpl)}")
    return _unflatten(like, iter([_from_numpy(t, a)
                                  for t, a in zip(tmpl, leaves)]))


def _atomic_write_text(path, text):
    path = pathlib.Path(path)
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _save_ckpt(path, leaves, meta, totals):
    """One atomic artifact holding the generator and sampler state,
    progress meta and info totals, so no kill window can leave state and
    progress inconsistent (bit-identical resume depends on them advancing
    together)."""
    arrays = {f"leaf_{i}": a for i, a in enumerate(leaves)}
    for k, v in totals.items():
        arrays[f"total__{k}"] = np.asarray(v)
    _write_npz(path, arrays, {"n_leaves": len(leaves), "meta": meta,
                              "total_keys": sorted(totals)})


def _load_ckpt(path, like):
    """Returns ``(arrays, meta, totals)``; raises ``ValueError`` on a
    structural mismatch with the tree ``like``. Nothing in ``like`` is
    changed."""
    with np.load(path, allow_pickle=False) as data:
        payload = json.loads(str(data["__meta__"]))
        leaves = [data[f"leaf_{i}"] for i in range(payload["n_leaves"])]
        totals = {k: np.asarray(data[f"total__{k}"])
                  for k in payload.get("total_keys", [])}
    tmpl = _flatten(like)
    if len(tmpl) != len(leaves):
        raise ValueError(f"checkpoint has {len(leaves)} leaves, template "
                         f"has {len(tmpl)}")
    for t, a in zip(tmpl, leaves):
        if torch.is_tensor(t) and tuple(a.shape) != tuple(t.shape):
            raise ValueError(f"checkpoint leaf has shape {a.shape}, "
                             f"template {tuple(t.shape)}")
    return leaves, payload["meta"], totals


def _merge_moments(mom, batch):
    """Chan-parallel merge of a kept-draw batch ``(k, *row)`` into running
    Welford moments ``(count, mean, m2)`` over the draw axis — exact, so
    streaming estimates equal batch estimates over the same draws."""
    batch = np.asarray(batch, np.float64)
    nb = batch.shape[0]
    mean_b = batch.mean(axis=0)
    m2_b = ((batch - mean_b) ** 2).sum(axis=0)
    if mom is None:
        return [np.asarray(nb, np.float64), mean_b, m2_b]
    na, mean_a, m2_a = mom
    n = na + nb
    delta = mean_b - mean_a
    mean = mean_a + delta * (nb / n)
    m2 = m2_a + m2_b + delta * delta * (na * nb / n)
    return [np.asarray(n, np.float64), mean, m2]


_MOM_KEYS = ("__mom_count", "__mom_mean", "__mom_m2")


def _host_copy(t, pinned):
    """A host copy of tensor ``t``: on the card an asynchronous copy into
    page-locked memory (``pinned`` when given, a buffer of the right
    shape), complete once an event recorded after it has fired; on the CPU
    a copy."""
    if t.device.type == "cpu":
        return t.detach().clone() if pinned is None else pinned.copy_(t)
    if pinned is None:
        return t.detach().to("cpu", non_blocking=True)
    return pinned.copy_(t, non_blocking=True)


def _sum_info(totals, chunk):
    """Fold one chunk's per-chain info sums into the running totals
    (integer counts as int64, float sums as float64)."""
    for k, v in chunk.items():
        v = np.asarray(v)
        totals[k] = totals[k] + v if k in totals else v
    return totals


class ChunkedRunner:
    """Restartable chunked execution of a batched transition kernel
    ``step(gen, state) -> (state, info)``.

    Draws (``collect_fn(state)`` after each kept transition) stream to a
    native :class:`~mcmc_tpu_torch.runtime.DrawSink`; the sampler state and
    the generator checkpoint after every chunk; per-draw info entries are
    accumulated into per-chain sums that survive resume (kept draws only,
    matching the reference's post-burn-in acceptance counting,
    src/rwmh.cpp:140-142).

    The chunk's draws collect in a buffer on the state's device and travel
    to the host through two page-locked buffers with ``non_blocking=True``;
    an event recorded after each copy is waited on only when that chunk is
    persisted, which happens after the next chunk has been launched, so the
    copy and the disk IO overlap the next chunk's compute.

    Calling :meth:`run` again with the same directory resumes from the last
    completed chunk and is bit-identical to an uninterrupted run.

    With ``shard`` (a :class:`~mcmc_tpu_torch.parallel.mesh.ChainShard`),
    every rank passes the global ``state0`` and the run's generator; each
    runs its block of the chains on its own generator
    (:func:`~mcmc_tpu_torch.parallel.mesh.rank_generator`), and at every
    chunk's end the ranks gather the chunk's draws, info sums, state and
    generator states, which rank 0 writes: a checkpoint holds the global
    state, so a run may resume on a different mesh size (the ranks'
    generators are then derived afresh from the run's seed and the
    completed draw count), and a killed run resumes bit-identically on the
    same mesh size. The directory must be on a file system every rank
    sees.
    """

    def __init__(self, step, collect_fn, directory, shard=None):
        self.step = step
        self.collect = collect_fn
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.shard = shard

    def run(self, gen, state0, n_draws, chunk_size=100, n_burnin=0,
            max_chunks=None, track_moments=False, progress=False):
        """Returns ``(final_state, draws, info_totals)`` with ``draws`` a
        host ``numpy.memmap`` of the sink's file, ``(n_draws, *row)``, and
        ``info_totals`` a dict of per-chain sums of every info entry over
        kept draws (``accepted`` being the acceptance count; divide by the
        kept-draw count for per-draw means — entries that are not counts
        or means produce sums with no standalone meaning). ``n_burnin``
        draws execute first without being stored. ``max_chunks`` stops
        after that many chunks (call again to continue).

        ``gen`` is the run's ``torch.Generator``: on resume its state is
        replaced by the checkpoint's.

        ``track_moments=True`` folds every kept draw into streaming Welford
        moments (exact Chan-parallel merges, resume-safe inside the atomic
        checkpoint) and returns them under ``info_totals["moments"]`` as
        ``{"count", "mean", "m2"}`` (float64 numpy arrays over the row).

        ``progress=True`` prints one status line per durable chunk (draws
        done / total, draws/s since start) to stderr; pass a callable
        instead to receive ``{"done", "total", "draws_per_s", "phase"}``
        after each persisted chunk."""
        total = n_burnin + n_draws
        chunk_size = max(int(chunk_size), 1)
        shard = self.shard
        writer = shard is None or dist.get_rank() == 0
        if shard is None:
            like, state = (gen, state0), state0
        else:
            from mcmc_tpu_torch.parallel import mesh as mesh_mod
            ax = shard.axis
            seed, gen = mesh_mod.rank_generator(gen, shard.rows.start)
            sgen = mesh_mod.shared_generator(seed, gen.device)
            # every rank's generator states, one row each: its own stream's
            # and the shared stream's
            like, state = (np.zeros((0,), np.uint8), state0), \
                shard.local(state0)
        gen_entry = gen.get_state()

        # the sink stores exactly what collect() produces (every rank's
        # rows): its shape and dtype (float64 runs stay float64)
        sample = self.collect(state)
        row_shape = tuple(sample.shape) if shard is None else \
            (shard.n,) + tuple(sample.shape[1:])
        dtype_name = str(sample.dtype).replace("torch.", "")
        dev = sample.device

        ckpt = self.dir / "state.npz"
        meta_path = self.dir / "progress.json"    # human-readable mirror only
        sink_path = self.dir / "draws.bin"
        run_meta = {"n_draws": n_draws, "chunk_size": chunk_size,
                    "n_burnin": n_burnin, "dtype": dtype_name}
        if shard is not None:
            run_meta["mesh_seed"] = str(seed)

        done = 0
        totals = {}
        mom = None
        if ckpt.exists():
            try:
                leaves, meta, saved = _load_ckpt(ckpt, like=like)
                # chunk_size does not affect results (the generator and
                # state stream are in the checkpoint; chunking only moves
                # persistence boundaries), and a larger n_draws continues
                # the same stream. Only n_burnin/dtype changes (or a total
                # below the completed count) force a restart — loudly.
                compat = (meta.get("n_burnin") == n_burnin
                          and meta.get("dtype") == dtype_name
                          and meta.get("done", 0) <= total)
                if compat:
                    if shard is None and np.ndim(leaves[0]) == 2:
                        # a sharded run's checkpoint resumed without a
                        # mesh: a fresh stream from its seed and progress
                        from mcmc_tpu_torch.samplers._resolve import \
                            stream_generator
                        leaves = [stream_generator(
                            int(meta["mesh_seed"]), meta["done"], 0,
                            device=gen.device).get_state().numpy()] \
                            + list(leaves[1:])
                    it = iter([_from_numpy(t, a) for t, a in
                               zip(_flatten(like), leaves)])
                    saved_gens, state = _unflatten(like, it)
                    done, totals = meta["done"], saved
                    if shard is not None:
                        state = shard.local(state)
                        if saved_gens.ndim == 2 and \
                                saved_gens.shape[0] == ax.size:
                            row = torch.from_numpy(
                                saved_gens[ax.index].copy())
                            half = row.shape[0] // 2
                            gen.set_state(row[:half].clone())
                            sgen.set_state(row[half:].clone())
                        else:
                            # another mesh size: fresh streams per rank
                            from mcmc_tpu_torch.samplers._resolve import \
                                stream_generator
                            s0 = int(meta.get("mesh_seed", seed))
                            gen = stream_generator(s0, done,
                                                   shard.rows.start,
                                                   device=gen.device)
                            sgen = stream_generator(s0, done, 0, 0,
                                                    device=gen.device)
                    if all(k in totals for k in _MOM_KEYS):
                        mom = [totals.pop(k) for k in _MOM_KEYS]
                else:
                    warnings.warn(
                        f"checkpoint in {self.dir} is from a run with "
                        f"n_burnin={meta.get('n_burnin')}, "
                        f"dtype={meta.get('dtype')}, done={meta.get('done')} "
                        f"(this run: n_burnin={n_burnin}, dtype={dtype_name}, "
                        f"total={total}); restarting from scratch and "
                        f"discarding its kept draws")
            except (ValueError, KeyError) as e:
                # a checkpoint of another sampler-state layout: restart
                # rather than crash
                gen.set_state(gen_entry)
                state = state0 if shard is None else shard.local(state0)
                totals, done = {}, 0
                warnings.warn(f"ignoring incompatible checkpoint in "
                              f"{self.dir}: {e}")

        t_start, done_start = time.monotonic(), done
        if writer and done == 0 and sink_path.exists():
            sink_path.unlink()
        kept_done = max(0, done - n_burnin)
        existing = None if done == 0 or not writer else \
            np.array(read_draws(sink_path, mmap=False)[:kept_done])
        if not track_moments:
            # stale moments the caller no longer maintains would miss this
            # run's chunks
            mom = None
        elif mom is None and existing is not None and kept_done > 0:
            mom = _merge_moments(None, existing)

        on_card = dev.type == "cuda"
        buf_shape = (min(chunk_size, max(n_draws, 1)),) + row_shape
        dev_buf = None
        host_bufs = []

        def host_buf(i):
            while len(host_bufs) <= i % 2:
                host_bufs.append(torch.empty(buf_shape, dtype=sample.dtype,
                                             pin_memory=on_card))
            return host_bufs[i % 2]

        n_chunks = 0
        # only rank 0 of a sharded run writes
        with (DrawSink(sink_path, row_shape, np.dtype(dtype_name)) if writer
              else contextlib.nullcontext()) as sink:
            if existing is not None and existing.shape[0]:
                sink.append(existing)

            def persist(chunk):
                """Durably record one finished chunk: draws -> sink ->
                flush -> one atomic state + progress + totals artifact."""
                nonlocal totals, mom
                if chunk["event"] is not None:
                    chunk["event"].synchronize()
                if chunk["kept"]:
                    host_draws = chunk["draws"].numpy()
                    sink.append(host_draws)
                    totals = _sum_info(totals, {k: v.numpy() for k, v in
                                                chunk["infos"].items()})
                    if track_moments:
                        mom = _merge_moments(mom, host_draws)
                # the native sink writes asynchronously: drain it before the
                # checkpoint claims these draws are durable
                sink.flush()
                pers = dict(totals)
                if mom is not None:
                    pers.update(dict(zip(_MOM_KEYS, mom)))
                leaves = [chunk["gen"].numpy()] + [
                    x.numpy() if torch.is_tensor(x) else np.asarray(x)
                    for x in chunk["state"]]
                _save_ckpt(ckpt, leaves, {"done": chunk["done"], **run_meta},
                           pers)
                _atomic_write_text(meta_path, json.dumps(
                    {"done": chunk["done"], **run_meta,
                     "info_totals": {k: np.asarray(v).tolist()
                                     for k, v in totals.items()}}))
                if progress:
                    elapsed = time.monotonic() - t_start
                    rate = (chunk["done"] - done_start) / max(elapsed, 1e-9)
                    info = {"done": chunk["done"], "total": total,
                            "draws_per_s": rate,
                            "phase": "keep" if chunk["kept"] else "burnin"}
                    if callable(progress):
                        progress(info)
                    else:
                        print(f"[ChunkedRunner] {info['phase']} "
                              f"{info['done']}/{total} draws "
                              f"({rate:.1f} draws/s)",
                              file=sys.stderr, flush=True)

            pending = None
            while done < total:
                if max_chunks is not None and n_chunks >= max_chunks:
                    break
                # chunks never straddle the burn-in/keep boundary
                kept = done >= n_burnin
                step_n = min(chunk_size, (total if kept else n_burnin) - done)
                sums = {}
                scope = contextlib.nullcontext() if shard is None else \
                    mesh_mod.sharded_chains(ax, sgen)
                with torch.no_grad(), scope:
                    for i in range(step_n):
                        state, info = self.step(gen, state)
                        if not kept:
                            continue
                        if dev_buf is None:
                            dev_buf = sample.new_empty(
                                buf_shape[:1] + tuple(sample.shape))
                        dev_buf[i] = self.collect(state)
                        for k, v in info.items():
                            v = torch.as_tensor(v)
                            v = v.to(torch.float64) if v.is_floating_point() \
                                else v.to(torch.int64)
                            sums[k] = sums[k] + v if k in sums else v
                gen_state, state_out, chunk_draws = gen.get_state(), state, \
                    dev_buf[:step_n] if kept else None
                if shard is not None:
                    # every rank's rows, generator and info sums
                    gen_state = mesh_mod.all_gather(
                        torch.cat([gen_state, sgen.get_state()])[None],
                        ax.group, ax.size)
                    state_out = shard.gather(state)
                    if kept:
                        chunk_draws = mesh_mod.all_gather(
                            chunk_draws, ax.group, ax.size, dim=1)
                        sums = {k: mesh_mod.all_gather(v, ax.group, ax.size)
                                for k, v in sums.items()}
                # the chunk is launched: queue its copies to the host, then
                # persist the previous chunk while the card works
                chunk = {"gen": gen_state, "kept": kept,
                         "done": done + step_n,
                         "state": [_host_copy(x, None) if torch.is_tensor(x)
                                   else x for x in _flatten(state_out)]}
                if kept:
                    chunk["draws"] = _host_copy(
                        chunk_draws, host_buf(n_chunks)[:step_n])
                    chunk["infos"] = {k: _host_copy(v, None)
                                      for k, v in sums.items()}
                chunk["event"] = None
                if on_card:
                    chunk["event"] = torch.cuda.Event()
                    chunk["event"].record()
                if pending is not None and writer:
                    persist(pending)
                pending = chunk
                done += step_n
                n_chunks += 1
            if pending is not None and writer:
                persist(pending)
        if shard is not None:
            # the other ranks read what rank 0 wrote
            dist.barrier()
            state = shard.gather(state)
            if not writer:
                totals = dict(_load_ckpt(ckpt, like=like)[2]) \
                    if ckpt.exists() else {}
                totals = {k: v for k, v in totals.items()
                          if k not in _MOM_KEYS}
        out_totals = dict(totals)
        if track_moments and mom is not None:
            out_totals["moments"] = {"count": mom[0], "mean": mom[1],
                                     "m2": mom[2]}
        return state, read_draws(sink_path, mode="c"), out_totals
