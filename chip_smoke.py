#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py [--reps 20] [--profile] [--out FILE]

``--profile`` also traces one Louvain run of the R-MAT graph, one LM
prefill and four batched LM decode steps under ``torch.profiler``.

Phases, each failing loudly (exit code 1, no result line):

1. Device: the card's name, the device count and
   ``nvidia-smi --query-gpu=name,power.limit``.  No card → failure.
2. Build: the ten CUDA kernels from ``src/repro_torch/kernels/csrc``,
   one ``nvcc`` per source, all started together; prints what
   ``-Xptxas -v`` reports for each (the wgmma flash kernel must not
   spill), the counts of ``HGMMA`` and ``UTMALDG`` instructions in the
   wgmma flash kernel's SASS (``cuobjdump -sass`` of the toolkit that
   built it), both above 0, and the float32 flash kernel's TF32
   tensor-core instructions (``HGMMA`` ... ``TF32``, or ``HMMA`` ...
   ``TF32``), above 0; its ``FFMA`` count is logged beside them (the
   exponentials' and divisions' only: no product runs on the CUDA
   cores).
3. Main path, on two graphs of real size built on the card with
   ``datasets.load(name, scale, device="cuda")``: the R-MAT ``as-skitter``
   stand-in at scale 1.0 (2^21 vertices, ~28 M directed edges), and the
   community-rich ``com-dblp`` stand-in at scale 1.0 (the SNAP graph's
   317 080 vertices, ~2 M directed edges).  The R-MAT graph's
   hub communities overflow the aggregation's bin gate at every level, so
   only the community-rich graph takes the binned path that launches
   ``bin_rank``.  On each: ``plp()`` and ``louvain()`` with
   ``backend="pallas"`` (the CUDA kernels) and ``table_mode="auto"``: the
   R-MAT graph's windows span its tables, so it stays resident; com-dblp's
   W = 16 bucket has narrow windows past half the shared-memory budget, so
   it takes the streamed kernels.  The mode each bucket took is logged.
   ``louvain()`` runs its default capacity cascade: the stages entered
   are logged, and its coarse levels score through the resident
   ``local_move`` kernel on the traced per-level tiles.
   Every launch counter of the five main-path kernels is set to 0 just
   before the ``pallas`` runs and read just after them; each must have
   launched, no streamed kernel may have launched on the R-MAT graph, the
   coarse levels of each graph must have launched ``local_move_louvain``
   (the resident ``local_move`` kernels' counters are read before and
   after each local-moving phase, tagged with its level, so their
   launches are logged per level and must add up to the run's), and the
   run reports must show no degradation.
   Then ``backend="ell"`` (plain PyTorch on the card) on both graphs, and
   ``table_mode="resident"`` on com-dblp: every run of a graph must agree
   on labels, iterations, levels, Q, every per-level history and the
   cascade's stages.
3a. Leiden, resume and faults (``[leiden]`` lines), on phase 3's two
   graphs already on the card.  ``leiden(g, LouvainConfig(backend=
   "pallas"))`` with the default cascade on each: the five main-path
   kernels' launch counters are set to 0 just before the run and read
   just after it, and ``local_move_louvain``'s are read around each
   local-moving phase (level = it0 // LEVEL_IT_STRIDE; the refinement,
   at it0 = level · 1000 + 500, runs the segment evaluator and launches
   nothing).  ``local_move_louvain`` must have launched at level 0 and
   on the coarse levels of each graph, all inside local-moving phases;
   ``local_move_louvain_streamed`` on com-dblp only; ``bin_rank`` once
   per level whose ``aggregation_per_level`` is ``"binned"`` (the
   refined coarsening); no PLP kernel; the report with no retry,
   degradation or fault (its watchdog warnings are logged).  Then
   ``leiden(backend="ell")`` on each graph must agree with it in labels,
   Q, levels, communities, every per-level history, aggregation and
   stages.  Wall times and the timer split (local moving, refinement,
   aggregation) of both runs are logged, Leiden's Q beside phase 3's
   Louvain Q (logged, not gated).  Then com-dblp's
   ``louvain(backend="pallas")`` with ``checkpoint_dir`` in a temporary
   directory and ``preempt_stage`` armed must raise ``Preempted`` after
   the first stage boundary committed; the rerun without the fault must
   resume once (``louvain.ckpt_resume``), equal phase 3's uninterrupted
   ``pallas`` run field by field and leave no ``step_*`` directory.  Last,
   com-dblp's ``louvain(backend="pallas")`` under ``vmem_starve`` and
   under ``binned_overflow``: labels and Q equal to the clean run's, the
   fault's counter moved (the table modes taken and the aggregation
   paths are logged: under a 1 KB budget the W = 16 bucket goes
   resident, under the overflow every level takes the sort fallback).
3c. Batch and serve (``[serve]`` lines).  256 ego-net stand-ins built on
   the card with the port's ``sbm`` (the JAX package's serving recipe,
   ``benchmarks/perf_variants.py``'s ``_egonet_standins``: sizes 25, 35,
   45, 3..5 blocks, p_in 0.35, p_out 0.03, per-graph seed seed + 7919·i,
   seed 0), all on one capacity signature (64, 256, W = 16), 32 chunks of
   8.  The five main-path kernels' launch counters are set to 0 just
   before ``louvain_batch(gs, LouvainConfig(backend="pallas"))`` and
   ``plp_batch(gs, PLPConfig(backend="pallas"))`` and read just after:
   ``local_move_louvain`` and ``local_move_plp`` must have launched, no
   streamed kernel (the lanes' traced tiles are resident), ``bin_rank``
   once per ``"binned"`` entry of the lanes' ``aggregation_per_level``;
   ``batch.unsorted_segment_fallback`` must not move and no lane's report
   may show a degradation, retry or fault.  Every lane must equal the
   single-graph ``louvain``/``plp`` run of its graph on ``pallas`` and the
   ``ell`` batch's lane in labels, Q, levels, communities, sweeps and every
   history.  On a second wave of 256 ego-nets (seed 1) the batched calls
   are timed against a loop of the single-graph drivers over the same
   graphs (graphs per second, logged with the card, not gated) and must
   equal them.  Then
   ``CommunityServeEngine(device="cuda", max_batch=8, max_retries=2)``
   with ``pallas`` configs serves the JAX side's service smoke traffic (12
   requests, n 24 / 96 — two signatures, W = 16 and 64 — m = 3n random
   ids, ``louvain`` when i % 3 else ``plp``, 60 s deadlines): every
   response ``ok`` and equal to its request's single-graph run, the
   sequential-ladder counters (``serve.batch_fallback_sequential``,
   ``serve.breaker_routed_sequential``) at 0; latencies logged.  One flush
   under ``transient_batch_fail`` with fuel 1: every request ``ok``,
   ``serve.retry`` moved.  Last, two requests with 500 ms deadlines under a
   6 s ``slow_dispatch`` stall must come back as ``DeadlineError`` within
   5 s; the abandoned watchdog workers (they sleep out the stall, then run
   their work on the card) are joined before the phase ends.  Expert
   placement at qwen3-moe-30b-a3b's router shape (128 experts, top-8) over
   65 536 skewed tokens (``tests/test_expert_placement.py``'s recipe, 16
   latent topics) onto 8 groups: ``louvain_placement`` on the card must be
   balanced (max − min ≤ 1) with a smaller cross-group share than
   ``random_placement``'s; both shares are logged.
3d. Distributed (``[dist]`` lines), on com-dblp (phase 3's graph, scale
   1.0).  The card's compute mode must be ``Default`` (several processes
   share it).  The single-device ``louvain(g, LouvainConfig())`` and
   ``leiden(...)`` (backend ``segment``) are the references.  (a) A
   one-rank NCCL group in this process (``launch.ranks.init_group``):
   shard-local and replicated ``distributed_louvain`` and shard-local
   ``distributed_leiden`` must equal them field by field (labels,
   communities, levels, Q and every per-level history); the per-level
   driver and ``distributed_plp`` run too, as world-1 references.  (b)
   Four gloo ranks spawned by ``launch.ranks.spawn_ranks``, all on
   cuda:0, each building com-dblp on the card from the seed: in every
   rank shard-local Louvain must equal (a), replicated Louvain must equal
   shard-local, shard-local Leiden the single-device Leiden,
   ``pipeline_fused=False`` and ``distributed_plp`` the world-1 runs,
   ``halo_cap=8`` must degrade to replicated with the same answer, and
   ``shard_drop`` must raise ``ShardError``.  Each rank reports through a
   file its wall seconds per call and ``bin_rank``'s launches (its
   counter read around each call: above 0 in every shard-local run, in
   (a) too), ``comm_stats`` and ``partition_stats``; the phase's total
   seconds are logged with the card.  ``bin_rank``'s row of the
   ``kernels`` line carries the phase's launches as ``dist_launches``.
   One card gives no multi-GPU number: (b) proves the shard-local code at
   world 4, its collectives staged through the host by gloo.
3b. Two-step scoring, the path the fused local_move kernels replaced: on
   every non-empty level-0 bucket of both graphs, the first and the last
   recorded sweep of PLP and Louvain, the (rows, W) tiles are gathered
   outside a kernel (``local_move/ref.py:_gather`` on the tables the main
   path built, as ``benchmarks/perf_variants.py``'s ``plp_two_step`` and
   ``louvain_two_step`` gather them) and scored through
   ``label_argmax(..., use_pallas=True)`` and ``delta_q_argmax(...,
   use_pallas=True)``, under unit, integer (1..8) and uniform float32
   weights; ``(best, propose)`` must equal the fused kernel's bit for bit.
   Then the GroupBy reduce through ``sorted_segment_sum(...,
   use_pallas=True)``: the R-MAT graph's weighted degrees from its
   src-sorted edges and com-dblp's first-level community volumes, each
   equal to the main path's own.  The three kernels' launch counters are
   set to 0 just before this path and read just after it.  Per bucket,
   the fused kernel's device time is printed beside the two-step's gather
   (CUDA events) and scoring kernel (device time), as the JAX package's
   ``gather_fusion`` mode prints them (``fused_s``, ``two_step_s``).
4. Kernels: each kernel against its plain version on the inputs the main
   path gave it (every level-0 ELL bucket and every coarse level's traced
   tile of both graphs, first and last sweep; the first level whose bin
   gate passed), with the graph's own weights and with integer weights
   1..8 — bit for bit — then timed:
   each kernel by device time (``device_ms``: CUDA events around
   ``--reps`` launches after warm-up, enqueued while a spin kernel holds
   the stream, so the wrapper's host work between launches is not in
   it), each plain
   version by ``loop_ms`` (CUDA events around back-to-back calls), beside
   the least time the card could take (``bound_ms``).  Every local_move
   tile is first checked against the tile contract (``graph/ell.py
   tile_contract``: sentinel rows hold only sentinels of weight 0), and
   its live rows, real slots, slots up to each live row's last real one,
   rows with more than one sentinel before their last real slot (which
   the builders' layout never makes: logged, not failed) and distinct
   table ids gathered are logged; the local_move bound (the contract
   bound) counts those slots and the table entries at those ids, and the
   log gives the full-tile bound (every slot, every table) beside it.
   Each streamed
   bucket is also timed through the resident kernel, and the bytes the
   streamed layout reads (tiles, one window per block per table, outputs)
   are printed beside the bound.  ``label_argmax`` and ``delta_q`` run on
   phase 3b's tiles (last sweep), ``block_segment_sums`` through
   ``sorted_segment_sum`` on its sorted keys, beside
   ``torch.segment_reduce`` on the same keys (``library_ms``, its lengths
   from ``torch.unique_consecutive`` timed apart); bit for bit on unit and
   integer weights, and on float32 weights — which the plain versions add
   with ``torch.sum`` in their own order, the kernels in ascending
   position order — scores within 1e-5 of the row's weight mass Σ|w| (the
   scale of a sum's rounding; a ΔQ gain, a difference of two sums, can be
   far smaller), labels equal wherever the plain version's top two scores
   differ by more than twice that, and segment sums within rtol = atol =
   1e-5.  The ``kernels`` line sums the R-MAT graph's four buckets (one
   level-0 sweep) for the resident and scored-tile kernels (the resident
   kernels' ``coarse_levels`` sum one sweep of each of its coarse levels,
   their ``launches`` read from the kernel's counter), com-dblp's
   streamed buckets for the streamed ones, and the R-MAT graph's 28 M
   sorted edge sources for ``block_segment_sums``.  ``bin_rank`` is
   checked and timed on the first and the last call of the first graph
   that launched it, each logged with its edges, width and rows read;
   its row keeps the first call's numbers and carries the launch floor
   (``floor_ms``: a one-element ``add_`` timed as the kernels are).  The
   card's clocks,
   temperature and power draw are printed before and after this phase.
5. LM: ``qwen3-1.7b`` at full width and depth (28 layers, d_model 2048,
   16 query heads over 8 KV heads repeated to 16, head dim 128, vocab
   151 936), its f32 master weights drawn by ``init_params(seed=0)`` on
   the card (parameter count, init time, peak memory logged).
   ``prefill_fn`` on (2, 4096) tokens drawn from the seed — 4096 is past
   the JAX package's 1024-key chunk, so the reference there takes its
   chunked path; ``prefill_32k`` (32 x 32 768) is cut to this for the
   time limit — twice, both flash kernels' launch counters set to 0
   before each call and read after it: exactly 28 launches of the wgmma
   kernel (bf16) per call and none of the float32 kernel, finite logits,
   wall time.  Then the float32 attention path: the last call's 28
   layers' (q, k, v) cast to float32 through ``flash_attention`` (the
   port's attention entry point), the counters set to 0 before and read
   after: 28 launches of the float32 kernel, none of the wgmma kernel.
   Layer 0's and layer 27's (q, k, v) of that prefill go through the
   wrapper and ``attention_ref``, in bf16 as the model gives them (the
   wgmma kernel) and cast to float32 (the float32 kernel); so do the
   shapes of ``tests/test_kernels.py`` plus ragged lengths (100, 1000) at
   head dim 128.  Float32 within rtol = atol = 1e-5; bf16 within one bf16
   ulp of the larger value plus 1e-6 (both sides keep the probabilities
   to float32 precision and round once).  Then
   ``ServeEngine(batch_slots=4, max_seq=512)`` answers 8 requests
   (prompts of 16-96 tokens, 16 new tokens each, all from the seed): every
   request returns 16 tokens, and the decode logits after each prompt lie
   within ``LM_LOGIT_REL`` of each row's largest |logit| of ``prefill_fn``'s
   last-position logits for that prompt (tokens/s and latencies logged).
   Last, device times at (2, 16, 4096, 128), causal: the wgmma kernel on
   bf16 inputs and the float32 kernel on the same inputs cast to float32,
   in turns (wgmma, float32, float32, wgmma); and the wgmma kernel at one
   ``prefill_32k`` sequence (1, 16, 32768, 128).  Each beside its plain
   version (CUDA events; skipped at 32 768, whose float32 scores alone
   are 64 GiB), ``F.scaled_dot_product_attention(is_causal=True)`` on the
   same inputs (the library call, CUDA events) and its bound max(the
   causal half of both products' flops, 2·B·Hq·Sq·Sk·D, at the inputs'
   tensor-core rate — bf16 at 989 TFLOP/s; float32 as three split-TF32
   products, 3 × 2·B·Hq·Sq·Sk·D at 495 TFLOP/s — , bytes of q, k, v, o /
   3.35 TB/s).  The float32 row's ``[lm]`` line also gives the bound of
   the same flops at 67 TFLOP/s, the CUDA cores' float32 rate.  Every
   check against ``attention_ref`` first asserts that
   ``torch.backends.cuda.matmul.allow_tf32`` is off: with it on, the
   plain version's float32 products would themselves run in TF32.

5t. Training (``[train]`` lines), on phase 5's qwen3-1.7b f32 master
   weights: three ``make_train_step`` steps (AdamW, ``grad_accum`` 4,
   ``remat="full"``) on ``ShapeCell("train_chip", "train", 4096, 8)``
   (``train_4k``'s global batch of 256 cut to 8, microbatch 2, to fit one
   card's 80 GB) with ``train.data.make_batch``'s batches.  Both flash
   kernels' counters are set to 0 before each step and read after it:
   exactly 2 x 28 x 4 = 224 wgmma launches (every layer's forward and its
   remat recompute, a microbatch) and none of the float32 kernel.  Loss
   and grad norm finite; step 0's loss beside ln V; step s, tokens/s,
   ``model_flops(cell)`` / step time as a share of 989 TFLOP/s, peak
   memory (the card's, and training's own: the peak less what earlier
   phases left allocated, the weights kept), and the device time of
   attention's plain backward (CUDA events
   around every ``FlashAttentionFn.backward``) as a share of the step.
   Then the gradient check: at full width and 2 layers, on one
   microbatch, the kernel path's loss and every gradient leaf against the
   same step with attention's plain mirror (``_flash_attention_chunked``)
   on the card, within ``tests/test_torch_cuda.py``'s tolerances (loss
   2^-8 relative, each leaf 2^-5 of its largest magnitude).  Last the
   resume check at the REDUCED config on the card (``launch.train.train``):
   4 steps with a checkpoint at 4, a resumed run to 6 and two
   uninterrupted runs of 6 must end at the same loss and parameters bit
   for bit.  The ``kernels`` rows of the flash kernels carry the three
   steps' launches as ``train_launches``.

The line before the last is the card as ``nvidia-smi`` prints it, the one
before that the ``kernels`` JSON line; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# The main path's graphs, (name in graph/datasets.py, scale): the R-MAT
# as-skitter stand-in, whose early levels overflow the bin gate, first; the
# community-rich com-dblp stand-in, whose later levels pass it.
MAIN_GRAPH = ("as-skitter", 1.0)
COMMUNITY_GRAPH = ("com-dblp", 1.0)

# Phase 3c ([serve]): ego-net stand-ins, the JAX package's serving recipe
# (benchmarks/perf_variants.py, _egonet_standins): sizes drawn from
# SERVE_SIZES, 3..5 planted blocks, p_in 0.35, p_out 0.03, per-graph seed
# seed + 7919·i — com-dblp-scale ego-nets of tens of vertices and a few
# hundred directed edges.  Two waves (seeds 0 and 1).
SERVE_EGONETS = 256
SERVE_SIZES = (25, 35, 45)
SERVE_SEED_STRIDE = 7919
# the service's last case: two requests of this deadline under a stalled
# dispatch must come back as DeadlineError within SERVE_ANSWER_S
SERVE_DEADLINE_MS = 500.0
SERVE_STALL_S = 6.0
SERVE_ANSWER_S = 5.0
# expert placement at qwen3-moe-30b-a3b's router shape (128 experts,
# top-8), over skewed routing with 16 latent topics, onto 8 groups
PLACEMENT = {"experts": 128, "top_k": 8, "tokens": 65536, "topics": 16,
             "groups": 8}

# Rows per block at which each streamed bucket is also timed.
STREAM_BLOCK_ROWS_SWEEP = (64, 128, 256, 512, 1024, 2048)

# NVIDIA H100 SXM data-sheet peaks used for the bound: HBM3 bandwidth and
# the 32-bit rate outside the tensor cores, which prices the compares and
# adds the functions need.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# Phase 5: the model, its prefill and serving shapes, and the tolerance of
# decode logits against prefill logits.  The two paths round differently
# (the flash kernel keeps its probabilities in float32, decode attention
# rounds them to bf16; cuBLAS sums a one-row and a 4096-row product in
# other orders), and 28 layers carry a few bf16 ulps of the hidden state
# into every logit at the scale of the row's largest.
LM_ARCH = "qwen3-1.7b"
LM_PREFILL = (2, 4096)
LM_LONG = (1, 32768)             # one prefill_32k sequence, kernel timing
LM_SERVE = {"batch_slots": 4, "max_seq": 512, "requests": 8,
            "prompt": (16, 96), "max_new": 16}
LM_LOGIT_REL = 2.0 ** -4
BF16_TFLOPS = 989e12
# the tensor cores' dense TF32 rate; a float32 product in split TF32 is
# three TF32 products
TF32_TFLOPS = 495e12
TF32_TERMS = 3
# the two flash kernels (bf16 on the tensor cores, float32 on the tensor
# cores in split TF32)
WGMMA = "flash_attention_fwd_wgmma"
F32_FLASH = "flash_attention_fwd"

# Phase 5t: train steps of LM_ARCH at full width and depth on train_4k's
# sequence length, its global batch of 256 cut to 8 (grad_accum 4,
# microbatch 2) to fit one card's 80 GB; the gradient check's depth; the
# REDUCED resume check's (seq_len, global batch), checkpoint step and
# steps; the gradient check's tolerances, tests/test_torch_cuda.py's.
TRAIN_CELL = ("train_chip", "train", 4096, 8)
TRAIN_STEPS = 3
TRAIN_GRAD_LAYERS = 2
TRAIN_RESUME_SHAPE = (64, 4)
TRAIN_RESUME_AT = 4
TRAIN_RESUME_STEPS = 6
TRAIN_LOSS_REL = 2.0 ** -8
TRAIN_GRAD_REL = 2.0 ** -5

# device_ms holds the stream with a spin kernel while the host enqueues
# the timed calls: the spin starts at twice the host's enqueue time (at
# least SPIN_MIN_S) at SPIN_CYCLES_PER_S (the H100's 1980 MHz SM clock
# maximum; a slower clock only spins longer), and is made SPIN_GROWTH
# times longer, up to SPIN_TRIES times, while it ends too soon.
SPIN_CYCLES_PER_S = 1.98e9
SPIN_MIN_S = 2e-3
SPIN_GROWTH = 4
SPIN_TRIES = 4


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------ kernel capture


class Recorder:
    """Wraps a kernel wrapper during the main path and keeps the arguments
    of the first and the last call per key, so phase 4 compares and times
    each kernel on inputs the main path really gave it.  The tensors are
    kept by reference: the main path never writes them after the call.
    Launches are read from the kernels' own counters, not counted here."""

    def __init__(self, fn, key):
        self.fn, self.key, self.calls = fn, key, {}
        self.tag = None          # the graph being run, set by phase_main
        self.level = 0           # the level being run, set by phase_main

    def __call__(self, *args, **kw):
        k = self.key(self, *args, **kw)
        first = self.calls.get(k, (None, None))[0]
        self.calls[k] = (first or (args, kw), (args, kw))
        return self.fn(*args, **kw)


# ------------------------------------------------------------ timing


def device_events(prof):
    """The trace's device-side events (kernels, copies, fills): the ones
    that carry device time exactly once.  Host-side operators also report
    the device time of the kernels they launched, so summing every event
    would count those kernels twice."""
    return [e for e in prof.events()
            if e.device_type.name == "CUDA"
            and not getattr(e, "is_user_annotation", False)]


def device_ms(fn, reps: int, torch) -> float:
    """Device milliseconds per call of ``fn()``: CUDA events around
    ``reps`` back-to-back calls, after three warm-up calls, enqueued while
    a spin kernel (``torch.cuda._sleep``) holds the stream.  The device
    then runs the calls with no wait on the host between them, so the
    wrapper's host work (checks, allocation, the ctypes call) is not in
    the time; the device's own gaps between launches are.  The spin lasts
    twice the warm-up's enqueue time of ``reps`` calls: if it has ended
    after the first call, that call waited on the device (a read-back),
    which this timing cannot take, and the run fails; if it ends before
    the last call is enqueued, it is made longer and the calls are timed
    again."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    spin_s = max(2 * (time.perf_counter() - t), SPIN_MIN_S)
    torch.cuda.synchronize()
    caller = sys._getframe(1)
    where = f"{Path(caller.f_code.co_filename).name}:{caller.f_lineno}"
    for _ in range(SPIN_TRIES):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin_s * SPIN_CYCLES_PER_S))
        a.record()
        for i in range(reps):
            fn()
            if i == 0 and a.query():
                fail(f"the function timed at {where} waits on the device")
        b.record()
        held = not a.query()
        b.synchronize()
        if held:
            return a.elapsed_time(b) / reps
        log(f"[timing] {where}: a {spin_s * 1e3:.3f} ms spin ended before "
            f"{reps} calls were enqueued; spinning {SPIN_GROWTH}x longer")
        spin_s *= SPIN_GROWTH
    fail(f"the spin never held the stream for {reps} calls at {where}")


def _events_ms(fn, reps: int, torch) -> float:
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def loop_ms(fn, reps: int, torch, budget_ms: float = 2000.0) -> float:
    """Milliseconds per call of ``fn()``: CUDA events around back-to-back
    calls after a warm-up call, over their count — ``reps`` calls, or
    fewer (at least 3) where one call takes so long that ``reps`` would
    pass ``budget_ms``.  Used for the plain versions, eager code whose
    thousands of small launches per call are host-bound, and for functions
    that read back to the host: the device's waits on the host between
    launches are part of their cost."""
    fn()
    one = _events_ms(fn, 1, torch)
    return _events_ms(fn, max(3, min(reps, int(budget_ms / max(one, 1e-3)))),
                      torch)


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def int_weights(w, torch, seed: int):
    """The tile's weights replaced by integers 1..8 (padding stays 0)."""
    gen = torch.Generator(device=w.device).manual_seed(seed)
    ints = torch.randint(1, 9, w.shape, generator=gen, device=w.device)
    return torch.where(w != 0, ints.to(w.dtype), w)


def f32_weights(w, torch, seed: int):
    """The tile's weights replaced by uniform float32 draws in [0, 1)
    (padding stays 0)."""
    gen = torch.Generator(device=w.device).manual_seed(seed)
    draws = torch.rand(w.shape, generator=gen, device=w.device)
    return torch.where(w != 0, draws, w)


def weightings(w, torch, seed: int):
    """The three weightings the scored-tile checks run under: the graph's
    own (unit), integers 1..8 and uniform float32."""
    return (("unit", w), ("int1..8", int_weights(w, torch, seed)),
            ("f32", f32_weights(w, torch, seed)))


def max_abs_err(a, b) -> float:
    if not a.numel():
        return 0.0
    if a.is_floating_point():
        same = (a == b) | (a.isinf() & b.isinf() & (a.sign() == b.sign()))
        return float((a - b).abs().where(~same, 0.0).max())
    return float((a.long() - b.long()).abs().max())


# ------------------------------------------------------------ phases


def phase_device(torch):
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"[device] {name} x{count}; nvidia-smi: {card}")
    return name, count, card


def phase_build(build):
    t = time.perf_counter()
    reports = build.build()
    for name in build.KERNELS:
        text = reports.get(name)
        log(f"[build] {name}: "
            + ("already built" if text is None else "ptxas -v:"))
        for line in (text or "").splitlines():
            if "ptxas" in line or "spill" in line:
                log(f"    {line.strip()}")
    log(f"[build] {len(reports)} kernel(s) built in "
        f"{time.perf_counter() - t:.1f} s")
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                        reports.get(WGMMA, ""))
    if any(int(a) or int(b) for a, b in spills):
        fail(f"{WGMMA} spills registers: {spills}")
    cuobjdump = Path(build.nvcc()).parent / "cuobjdump"
    if not cuobjdump.exists():
        fail(f"no cuobjdump next to nvcc ({cuobjdump})")
    sass = subprocess.run(
        [str(cuobjdump), "-sass", str(build.lib_path(WGMMA))],
        capture_output=True, text=True, timeout=300)
    if sass.returncode != 0:
        fail(f"cuobjdump -sass failed: {sass.stderr.strip()}")
    counts = {op: sass.stdout.count(op) for op in ("HGMMA", "UTMALDG")}
    log(f"[build] {WGMMA} SASS: " + ", ".join(f"{op} {n}"
                                               for op, n in counts.items()))
    if not all(counts.values()):
        fail(f"{WGMMA} SASS lacks tensor-core or TMA instructions: {counts}")
    sass = subprocess.run(
        [str(cuobjdump), "-sass", str(build.lib_path(F32_FLASH))],
        capture_output=True, text=True, timeout=300)
    if sass.returncode != 0:
        fail(f"cuobjdump -sass failed: {sass.stderr.strip()}")
    lines = sass.stdout.splitlines()
    tf32 = sum("MMA" in line and "TF32" in line for line in lines)
    ffma = sum("FFMA" in line for line in lines)
    log(f"[build] {F32_FLASH} SASS: HGMMA/HMMA ... TF32 {tf32}, FFMA {ffma} "
        f"(exponentials and divisions)")
    if not tf32:
        fail(f"{F32_FLASH} SASS lacks TF32 tensor-core instructions")


PLP_FIELDS = ("labels", "iterations", "delta_n_history", "active_history")
LOUVAIN_FIELDS = ("labels", "n_communities", "levels", "modularity",
                  "modularity_history", "sweeps_per_level", "n_comm_per_level",
                  "delta_n_per_level", "aggregation_per_level",
                  "cascade_stages")


def compare_runs(a, b, fields, what):
    import numpy as np

    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        same = (np.array_equal(x, y) if isinstance(x, np.ndarray) else x == y)
        if not same:
            fail(f"{what} differ in {f}")


def table_modes(telemetry, before):
    """{"w16": "streamed", ...}: the table mode each bucket took since the
    telemetry snapshot ``before`` (``local_move.<mode>.w<W>`` counters)."""
    modes = {}
    for k, v in telemetry.snapshot().items():
        if k.startswith("local_move.") and v > before.get(k, 0):
            _, mode, width = k.split(".")
            modes.setdefault(width, set()).add(mode)
    return {w: "/".join(sorted(m)) for w, m in sorted(modes.items())}


def _summary(plp_res, lv_res, g):
    if not (0.0 < lv_res.modularity <= 1.0):
        fail(f"implausible modularity {lv_res.modularity!r}")
    if len(plp_res.labels) != g.n_max or len(lv_res.labels) != g.n_max:
        fail("label vectors do not cover the graph")
    return {
        "plp_iterations": plp_res.iterations,
        "plp_communities": int(len(set(plp_res.labels.tolist()))),
        "louvain_levels": lv_res.levels,
        "louvain_communities": lv_res.n_communities,
        "modularity": lv_res.modularity,
        "sweeps_per_level": lv_res.sweeps_per_level,
        "n_comm_per_level": lv_res.n_comm_per_level,
        "aggregation_per_level": lv_res.aggregation_per_level,
        "cascade_stages": lv_res.cascade_stages,
        "warnings": lv_res.run_report.warnings,
        "louvain_timer_s": lv_res.timer.totals,
        "plp_timer_s": plp_res.timer.totals}


def phase_main(torch, rt):
    """Both graphs of the main path: the R-MAT stand-in (PLP + Louvain, its
    early levels overflow the bin gate) and a community-rich stand-in
    (PLP + Louvain, whose later levels pass it, so ``bin_rank`` runs)."""
    dev = torch.device("cuda")
    graphs = {}
    for name, scale in (MAIN_GRAPH, COMMUNITY_GRAPH):
        t = time.perf_counter()
        lg = rt.datasets.load(name, scale=scale, device=dev)
        torch.cuda.synchronize()
        ingest = time.perf_counter() - t
        t = time.perf_counter()
        ell = rt.build_ell(lg.graph)
        torch.cuda.synchronize()
        info = {"scale": scale, "n": lg.graph.n_max,
                "m_directed": lg.graph.m_valid, "ingest_s": ingest,
                "ell_build_s": time.perf_counter() - t,
                "ell_rows": {b.width: b.n_rows_valid for b in ell.buckets},
                "windows": {b.width: {"blocks": int(b.windows.win_blk.numel()),
                                      "block_rows": b.windows.block_rows,
                                      "slot": b.windows.slot}
                            for b in ell.buckets if b.n_rows_valid},
                "tail_vertices": int(ell.tail_vertices.numel())}
        graphs[name] = (lg.graph, ell, info)
        log(f"[main] {name} scale {scale}: n={info['n']} directed edges="
            f"{info['m_directed']}; ingest {ingest:.2f} s; ELL build "
            f"{info['ell_build_s']:.2f} s, rows per width {info['ell_rows']},"
            f" tail vertices {info['tail_vertices']}; streamed-layout "
            f"windows per width {info['windows']}")

    # capture the kernels' main-path inputs, per graph, level and ELL
    # width: level 0's host-built buckets and the coarse levels' traced
    # tiles are kept apart
    def by_width(rec, rows, nbr, *a, **k):
        return rec.tag, rec.level, nbr.shape[1]

    rec_plp = Recorder(rt.lm_kernel.local_move_plp_kernel, by_width)
    rec_lv = Recorder(rt.lm_kernel.local_move_louvain_kernel, by_width)
    rec_bin = Recorder(rt.agg_kernel.bin_rank_kernel,
                       lambda rec, *a, **k: rec.tag)
    rec_plp_s = Recorder(rt.lm_kernel.local_move_plp_streamed_kernel,
                         by_width)
    rec_lv_s = Recorder(rt.lm_kernel.local_move_louvain_streamed_kernel,
                        by_width)
    recs = (rec_plp, rec_lv, rec_bin, rec_plp_s, rec_lv_s)
    streamed = (rec_plp_s.fn, rec_lv_s.fn)
    for r in recs:
        setattr(rt.agg_ops if r is rec_bin else rt.lm_ops, r.fn.__name__, r)
    # the level of each local-moving phase: its sweep counter starts at
    # level · LEVEL_IT_STRIDE (PLP runs level 0 only); the resident
    # local_move kernels' launch counters are read before and after each
    # phase, so their launches are known per graph and level
    run_phase = rt.SweepEngine.run_phase
    lm_counters = (rec_plp.fn, rec_lv.fn)
    per_level = {}           # graph -> kernel -> level -> launches

    def tagged_run_phase(self, labels, active, *, it0=0, **kw):
        level = it0 // rt.LEVEL_IT_STRIDE
        for r in recs:
            r.level = level
        before = [c.launches for c in lm_counters]
        out = run_phase(self, labels, active, it0=it0, **kw)
        for c, b in zip(lm_counters, before):
            k = c.__name__.replace("_kernel", "")
            by_level = per_level.setdefault(recs[0].tag, {}).setdefault(k, {})
            by_level[level] = by_level.get(level, 0) + c.launches - b
        return out

    rt.SweepEngine.run_phase = tagged_run_phase

    counters = tuple(r.fn for r in recs)
    for c in counters:
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    runs = {}
    for name, (g, ell, info) in graphs.items():
        for r in recs:
            r.tag = name
        before = rt.telemetry.snapshot()
        t = time.perf_counter()
        plp_res = rt.plp(g, rt.PLPConfig(backend="pallas"), ell_graph=ell)
        torch.cuda.synchronize()
        info["plp_s"] = time.perf_counter() - t
        info["plp_table_modes"] = table_modes(rt.telemetry, before)
        before = rt.telemetry.snapshot()
        t = time.perf_counter()
        lv_res = rt.louvain(g, rt.LouvainConfig(backend="pallas"))
        torch.cuda.synchronize()
        info["louvain_s"] = time.perf_counter() - t
        info["louvain_table_modes"] = table_modes(rt.telemetry, before)
        runs[name] = (plp_res, lv_res)
        log(f"[main] {name}: table mode per ELL bucket (auto): PLP "
            f"{info['plp_table_modes']}, Louvain level 0 "
            f"{info['louvain_table_modes']}; streamed launches so far "
            f"{[c.launches for c in streamed]}")
        if name == MAIN_GRAPH[0] and any(c.launches for c in streamed):
            fail(f"{name} launched a streamed kernel: its windows span the "
                 f"tables, so auto must keep it resident")
    launches = {c.__name__.replace("_kernel", ""): c.launches
                for c in counters}
    peak = torch.cuda.max_memory_allocated() / 2**30
    for r in recs:
        setattr(rt.agg_ops if r is rec_bin else rt.lm_ops, r.fn.__name__, r.fn)
    rt.SweepEngine.run_phase = run_phase
    log(f"[main] pallas runs done; peak memory {peak:.2f} GiB; launches "
        f"{launches}")
    for name, count in launches.items():
        if count <= 0:
            fail(f"kernel {name} was launched no time on the main path")
    for c in lm_counters:
        k = c.__name__.replace("_kernel", "")
        phased = sum(v.get(k, {}).get(lvl, 0) for v in per_level.values()
                     for lvl in v.get(k, {}))
        if phased != launches[k]:
            fail(f"{k}: {launches[k]} launches, {phased} of them inside a "
                 f"local-moving phase")
    coarse = {}
    for name, (plp_res, lv_res) in runs.items():
        mine = per_level.get(name, {})
        widths = {r.fn.__name__.replace("_kernel", ""): sorted(
            {(lvl, w) for (g, lvl, w) in r.calls if g == name})
            for r in (rec_plp, rec_lv)}
        coarse[name] = {k: sum(c for lvl, c in v.items() if lvl)
                        for k, v in mine.items()}
        graphs[name][2]["launches_per_level"] = mine
        graphs[name][2]["coarse_launches"] = coarse[name]
        log(f"[main] {name}: Louvain cascade stages {lv_res.cascade_stages}; "
            f"local_move launches per level {mine} ((level, width) pairs "
            f"{widths}); on the coarse levels {coarse[name]}")
        if coarse[name].get("local_move_louvain", 0) <= 0:
            fail(f"{name}'s coarse levels launched no local_move kernel")

    for name, (g, ell, info) in graphs.items():
        plp_k, lv_k = runs[name]
        for res, what in ((plp_k, "plp"), (lv_k, "louvain")):
            if res.run_report.degradations:
                fail(f"{name} {what} degraded: {res.run_report.degradations}")
        others = [("ell", "auto")]
        if name == COMMUNITY_GRAPH[0]:
            others.append(("pallas", "resident"))
        for backend, mode in others:
            tag = f"{backend}_{mode}"
            t = time.perf_counter()
            plp_o = rt.plp(g, rt.PLPConfig(backend=backend, table_mode=mode),
                           ell_graph=ell)
            torch.cuda.synchronize()
            info[f"plp_{tag}_s"] = time.perf_counter() - t
            t = time.perf_counter()
            lv_o = rt.louvain(g, rt.LouvainConfig(backend=backend,
                                                  table_mode=mode))
            torch.cuda.synchronize()
            info[f"louvain_{tag}_s"] = time.perf_counter() - t
            what = f"{name}: pallas/auto and {backend}/{mode}"
            compare_runs(plp_k, plp_o, PLP_FIELDS, f"{what} plp")
            compare_runs(lv_k, lv_o, LOUVAIN_FIELDS, f"{what} louvain")
        info.update(_summary(plp_k, lv_k, g))
        paths = lv_k.aggregation_per_level
        resident = (f"; pallas/resident PLP {info['plp_pallas_resident_s']:.2f}"
                    f" s, Louvain {info['louvain_pallas_resident_s']:.2f} s"
                    if "plp_pallas_resident_s" in info else "")
        log(f"[main] {name}: PLP pallas {info['plp_s']:.2f} s / ell "
            f"{info['plp_ell_auto_s']:.2f} s ({plp_k.iterations} iterations, "
            f"{info['plp_communities']} communities); Louvain pallas "
            f"{info['louvain_s']:.2f} s / ell "
            f"{info['louvain_ell_auto_s']:.2f} s, Q={lv_k.modularity!r}, "
            f"{lv_k.levels} levels, {lv_k.n_communities} communities"
            f"{resident}; every run agrees in labels, iterations, levels, Q "
            f"and every history")
        log(f"[main] {name}: cascade stages {lv_k.cascade_stages}; per "
            f"level communities {lv_k.n_comm_per_level}, "
            f"sweeps {lv_k.sweeps_per_level}, aggregation {paths} (binned "
            f"{paths.count('binned')}, sort fallback "
            f"{paths.count('sort_fallback')}); Louvain timer "
            f"{ {k: round(v, 3) for k, v in lv_k.timer.totals.items()} }")
    out = {"graphs": {k: v[2] for k, v in graphs.items()},
           "launches": launches, "coarse_launches": coarse,
           "peak_mem_gib": peak}
    return out, recs, graphs, runs


# ------------------------------------------------ phase 3a: Leiden, resume


def timer_split(res) -> dict:
    """The run's timer: local moving, refinement, aggregation (s)."""
    t = res.timer.totals
    return {k: round(t.get(k, 0.0), 4)
            for k in ("local_moving", "refinement", "aggregation")}


def timed_run(torch, fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t


def phase_leiden(torch, rt, graphs, runs):
    """Leiden on both graphs through the kernels and through the plain
    backend, then com-dblp's stage checkpoint killed and resumed, and two
    fault points, on the card."""
    import numpy as np

    lm, agg = rt.lm_kernel, rt.agg_kernel
    counters = {"local_move_plp": lm.local_move_plp_kernel,
                "local_move_louvain": lm.local_move_louvain_kernel,
                "bin_rank": agg.bin_rank_kernel,
                "local_move_plp_streamed": lm.local_move_plp_streamed_kernel,
                "local_move_louvain_streamed":
                    lm.local_move_louvain_streamed_kernel}
    louvain_k = counters["local_move_louvain"]
    run_phase = rt.SweepEngine.run_phase
    per_level: dict = {}

    def tagged_run_phase(self, labels, active, *, it0=0, **kw):
        before = louvain_k.launches
        out = run_phase(self, labels, active, it0=it0, **kw)
        level = it0 // rt.LEVEL_IT_STRIDE
        per_level[level] = per_level.get(level, 0) + louvain_k.launches \
            - before
        return out

    out = {"graphs": {}}
    for name, (g, _ell, _info) in graphs.items():
        louvain_res = runs[name][1]
        per_level.clear()
        rt.SweepEngine.run_phase = tagged_run_phase
        for c in counters.values():
            c.launches = 0
        res, wall = timed_run(torch, lambda: rt.leiden(
            g, rt.LouvainConfig(backend="pallas")))
        launches = {k: c.launches for k, c in counters.items()}
        rt.SweepEngine.run_phase = run_phase
        rep = res.run_report
        paths = res.aggregation_per_level
        ell_res, ell_wall = timed_run(torch, lambda: rt.leiden(
            g, rt.LouvainConfig(backend="ell")))
        compare_runs(res, ell_res, LOUVAIN_FIELDS,
                     f"{name}: leiden pallas and ell")
        coarse = sum(v for lvl, v in per_level.items() if lvl)
        info = {"wall_s": wall, "ell_wall_s": ell_wall,
                "timer_s": timer_split(res),
                "ell_timer_s": timer_split(ell_res), "launches": launches,
                "local_move_louvain_per_level": dict(per_level),
                "modularity": res.modularity,
                "louvain_modularity": louvain_res.modularity,
                "levels": res.levels, "communities": res.n_communities,
                "n_comm_per_level": res.n_comm_per_level,
                "sweeps_per_level": res.sweeps_per_level,
                "aggregation_per_level": paths,
                "cascade_stages": res.cascade_stages,
                "warnings": rep.warnings}
        out["graphs"][name] = info
        log(f"[leiden] {name}: leiden(pallas) {wall:.2f} s, timer "
            f"{info['timer_s']}; leiden(ell) {ell_wall:.2f} s, timer "
            f"{info['ell_timer_s']}; both agree in labels, Q, levels, "
            f"communities, every history, aggregation and stages")
        log(f"[leiden] {name}: Q={res.modularity!r} (louvain "
            f"{louvain_res.modularity!r}), {res.levels} levels, "
            f"{res.n_communities} communities, stages {res.cascade_stages}, "
            f"communities per level {res.n_comm_per_level}, aggregation "
            f"{paths}, warnings {rep.warnings}")
        log(f"[leiden] {name}: launches {launches}; local_move_louvain per "
            f"level {dict(per_level)}")
        if rep.retries or rep.degradations or rep.faults:
            fail(f"{name} leiden report not clean: {rep.as_dict()}")
        if per_level.get(0, 0) <= 0 or coarse <= 0:
            fail(f"{name} leiden: local_move_louvain launched {per_level} "
                 f"times per level; level 0 and the coarse levels must "
                 f"launch it")
        if sum(per_level.values()) != launches["local_move_louvain"]:
            fail(f"{name} leiden: local_move_louvain launched outside a "
                 f"local-moving phase")
        if launches["bin_rank"] != paths.count("binned"):
            fail(f"{name} leiden: bin_rank launched {launches['bin_rank']} "
                 f"times for {paths.count('binned')} binned levels")
        if launches["local_move_plp"] or launches["local_move_plp_streamed"]:
            fail(f"{name} leiden launched a PLP kernel")
        streamed = launches["local_move_louvain_streamed"]
        if (name == COMMUNITY_GRAPH[0]) != (streamed > 0):
            fail(f"{name} leiden: {streamed} streamed launches (com-dblp "
                 f"must stream its W = 16 bucket, as-skitter must not)")

    name = COMMUNITY_GRAPH[0]
    g = graphs[name][0]
    clean = runs[name][1]
    cfg = rt.LouvainConfig(backend="pallas")
    with tempfile.TemporaryDirectory() as ckpt:
        cfg_ck = cfg.replace(checkpoint_dir=ckpt)
        saves = rt.telemetry.get("louvain.ckpt_save")
        resumes = rt.telemetry.get("louvain.ckpt_resume")
        try:
            with rt.faultinject.inject("preempt_stage"):
                rt.louvain(g, cfg_ck)
            fail(f"{name}: preempt_stage did not stop the run")
        except rt.Preempted as err:
            steps = sorted(p for p in os.listdir(ckpt)
                           if p.startswith("step_"))
            log(f"[leiden] {name} resume: killed ({err}); committed "
                f"{steps}")
        if not steps or rt.telemetry.get("louvain.ckpt_save") - saves != 1:
            fail(f"{name}: the kill came before a boundary committed")
        resumed, wall = timed_run(torch, lambda: rt.louvain(g, cfg_ck))
        n_resumed = rt.telemetry.get("louvain.ckpt_resume") - resumes
        if n_resumed != 1:
            fail(f"{name}: the rerun resumed {n_resumed} times, not once")
        compare_runs(clean, resumed, LOUVAIN_FIELDS,
                     f"{name}: uninterrupted and resumed pallas runs")
        left = [p for p in os.listdir(ckpt) if p.startswith("step_")]
        if left:
            fail(f"{name}: the resumed run left {left} behind")
    out["resume"] = {"graph": name, "resumed_wall_s": wall,
                     "stages": resumed.cascade_stages}
    log(f"[leiden] {name} resume: the rerun resumed once ({wall:.2f} s) and "
        f"equals phase 3's uninterrupted pallas run field by field; no "
        f"step_* left")

    out["faults"] = {}
    for fault, counter in (("vmem_starve", "fault.vmem_starve.budget_clamped"),
                           ("binned_overflow",
                            "fault.binned_overflow.forced")):
        before = rt.telemetry.get(counter)
        modes = rt.telemetry.snapshot()
        with rt.faultinject.inject(fault):
            res, wall = timed_run(torch, lambda: rt.louvain(g, cfg))
        moved = rt.telemetry.get(counter) - before
        taken = table_modes(rt.telemetry, modes)
        if not np.array_equal(res.labels, clean.labels) \
                or res.modularity != clean.modularity:
            fail(f"{name} under {fault}: labels or Q differ from the clean "
                 f"run")
        if moved <= 0 or res.run_report.faults != [fault]:
            fail(f"{name} under {fault}: counter {counter} moved {moved}, "
                 f"report faults {res.run_report.faults}")
        out["faults"][fault] = {"wall_s": wall, "counter": moved,
                                "table_modes": taken,
                                "aggregation": res.aggregation_per_level}
        log(f"[leiden] {name} under {fault}: {wall:.2f} s, labels and Q "
            f"equal to the clean run; {counter} +{moved}; table modes "
            f"taken (level 0 and the coarse tiles) {taken}; aggregation "
            f"{res.aggregation_per_level}")
    return out


# ------------------------------------------------ phase 3d: distributed

# the compared fields of a DistLouvainResult; aggregation_per_level and
# cascade_stages of the single-device LouvainResult have no counterpart
DIST_FIELDS = ("labels", "n_communities", "levels", "modularity",
               "sweeps_per_level", "n_comm_per_level", "modularity_history",
               "delta_n_per_level")
DIST_RANKS = 4
DIST_HALO_CAP = 8           # small enough that com-dblp's level 0 overflows
DIST_TIMEOUT_S = 600        # the 4-rank run, spawn to the last rank's exit
DIST_COLLECTIVE_S = 120     # a rank waiting on a peer that has gone


def dist_fields(r) -> dict:
    """A DistLouvainResult as one rank reports it to the parent."""
    return {f: getattr(r, f) for f in DIST_FIELDS + (
        "coarsening", "comm_stats", "partition_stats")} | {
        "degradations": [d["kind"] for d in r.run_report.degradations],
        "timer_s": dict(r.timer.totals)}


def dist_cases(g, group=None) -> dict:
    """The distributed calls one rank makes on ``g``, each timed and with
    its ``bin_rank`` launches counted (the counter read around the call):
    shard-local and replicated Louvain, shard-local Leiden, the per-level
    driver and PLP; with more than one rank also the halo-cap overflow and
    ``shard_drop``."""
    import torch

    from repro_torch.core import distributed as dmod
    from repro_torch.kernels.aggregation.kernel import bin_rank_kernel
    from repro_torch.utils import faultinject
    from repro_torch.utils.errors import ShardError

    calls = {
        "louvain_shard_local": lambda: dmod.distributed_louvain(g, group),
        "louvain_replicated": lambda: dmod.distributed_louvain(
            g, group, coarsening="replicated"),
        "leiden_shard_local": lambda: dmod.distributed_leiden(g, group),
        "louvain_per_level": lambda: dmod.distributed_louvain(
            g, group, pipeline_fused=False),
        "plp": lambda: dmod.distributed_plp(g, group)}
    if torch.distributed.get_world_size(group) > 1:
        calls["louvain_halo8"] = lambda: dmod.distributed_louvain(
            g, group, halo_cap=DIST_HALO_CAP)
    out = {}
    for key, call in calls.items():
        before = bin_rank_kernel.launches
        _sync(torch, g)
        t = time.perf_counter()
        res = call()
        _sync(torch, g)
        out[key] = {"wall_s": time.perf_counter() - t,
                    "bin_rank": bin_rank_kernel.launches - before,
                    "result": (res if key == "plp" else dist_fields(res))}
    if torch.distributed.get_world_size(group) > 1:
        try:
            with faultinject.inject("shard_drop"):
                dmod.distributed_louvain(g, group)
            out["shard_drop"] = "no error"
        except ShardError as err:
            out["shard_drop"] = type(err).__name__
    return out


def _sync(torch, g) -> None:
    if g.device.type == "cuda":
        torch.cuda.synchronize()


def dist_rank(rank: int, world: int, name: str, scale: float,
              device: str) -> dict:
    """One rank of phase 3d's gloo group (spawned): builds the graph on
    ``device`` (the card) from the seed, as every rank does, and runs
    ``dist_cases``."""
    import torch

    from repro_torch.graph import datasets

    t = time.perf_counter()
    g = datasets.load(name, scale=scale, device=torch.device(device)).graph
    _sync(torch, g)
    out = dist_cases(g)
    out["load_s"] = time.perf_counter() - t - sum(
        v["wall_s"] for v in out.values() if isinstance(v, dict))
    out["device"] = str(g.device)
    return out


def _same_dist(a: dict, b, what: str) -> None:
    """``a`` (a rank's report) equal to ``b`` (a report or a LouvainResult)
    in every DIST_FIELDS entry."""
    import numpy as np

    for f in DIST_FIELDS:
        x = a[f]
        y = b[f] if isinstance(b, dict) else getattr(b, f)
        if not (np.array_equal(x, y) if f == "labels" else x == y):
            fail(f"{what} differ in {f}")


def phase_dist(torch, rt, graphs, card: str, scale: float | None = None):
    """(a) a one-rank NCCL group in this process and (b) a 4-rank gloo
    group, every rank on cuda:0, run the distributed drivers on com-dblp;
    each must equal the single-device ``segment`` runs."""
    import numpy as np

    name = COMMUNITY_GRAPH[0]
    scale = COMMUNITY_GRAPH[1] if scale is None else scale
    g = graphs[name][0]
    t0 = time.perf_counter()
    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    log(f"[dist] compute mode {mode!r} ({card})")
    if mode.splitlines()[0] != "Default":
        fail(f"the card's compute mode is {mode!r}: several ranks on one "
             f"card need Default")
    single, s_lv = timed_run(torch, lambda: rt.louvain(g, rt.LouvainConfig()))
    single_ld, s_ld = timed_run(torch, lambda: rt.leiden(
        g, rt.LouvainConfig()))
    log(f"[dist] {name}: single-device segment louvain {s_lv:.2f} s "
        f"(Q={single.modularity!r}, {single.levels} levels), leiden "
        f"{s_ld:.2f} s (Q={single_ld.modularity!r}) ({card})")

    # (a) one rank, NCCL, this process
    with tempfile.TemporaryDirectory() as tmp:
        group = rt.init_group("nccl", 0, 1, f"file://{tmp}/rendezvous",
                              timeout_s=DIST_COLLECTIVE_S)
        try:
            one = dist_cases(g, group)
        finally:
            torch.distributed.destroy_process_group()
    _same_dist(one["louvain_shard_local"]["result"], single,
               f"{name}: NCCL world 1 shard-local and single-device louvain")
    _same_dist(one["louvain_replicated"]["result"], single,
               f"{name}: NCCL world 1 replicated and single-device louvain")
    _same_dist(one["leiden_shard_local"]["result"], single_ld,
               f"{name}: NCCL world 1 shard-local and single-device leiden")
    for key in ("louvain_shard_local", "leiden_shard_local"):
        if one[key]["bin_rank"] <= 0:
            fail(f"{name}: NCCL world 1 {key} launched no bin_rank")
    for key, v in one.items():
        log(f"[dist] (a) nccl x1 {key}: {v['wall_s']:.2f} s, bin_rank "
            f"{v['bin_rank']} launches ({card})")
    res = one["louvain_shard_local"]["result"]
    log(f"[dist] (a) nccl x1: shard-local/replicated louvain and leiden equal "
        f"the single-device segment runs field by field; comm "
        f"{res['comm_stats']}; partition {res['partition_stats']}")

    # (b) four ranks, gloo, all on cuda:0, each building the graph itself
    t = time.perf_counter()
    ranks = rt.spawn_ranks(dist_rank, DIST_RANKS, backend="gloo",
                           args=(name, scale, str(g.device)),
                           timeout_s=DIST_TIMEOUT_S,
                           collective_timeout_s=DIST_COLLECTIVE_S)
    wall_b = time.perf_counter() - t
    for r, rep in enumerate(ranks):
        what = f"{name}: gloo rank {r}/{DIST_RANKS}"
        if rep["device"] != str(g.device):
            fail(f"{what} ran on {rep['device']}")
        lv, rp = (rep[k]["result"] for k in ("louvain_shard_local",
                                             "louvain_replicated"))
        _same_dist(lv, one["louvain_shard_local"]["result"],
                   f"{what} shard-local louvain and (a)")
        _same_dist(rp, lv, f"{what} replicated and shard-local louvain")
        _same_dist(rep["leiden_shard_local"]["result"], single_ld,
                   f"{what} shard-local leiden and single-device leiden")
        _same_dist(rep["louvain_per_level"]["result"],
                   one["louvain_per_level"]["result"],
                   f"{what} per-level louvain and world 1")
        labels, hist = rep["plp"]["result"]
        labels1, hist1 = one["plp"]["result"]
        if not (np.array_equal(labels, labels1) and hist == hist1):
            fail(f"{what} plp differs from world 1")
        halo = rep["louvain_halo8"]["result"]
        if halo["coarsening"] != "replicated" \
                or halo["degradations"] != ["halo_overflow"]:
            fail(f"{what} halo_cap={DIST_HALO_CAP} did not degrade to "
                 f"replicated: {halo['coarsening']} {halo['degradations']}")
        _same_dist(halo, rp, f"{what} halo-overflow retry and replicated")
        if rep["shard_drop"] != "ShardError":
            fail(f"{what} shard_drop gave {rep['shard_drop']!r}")
        for key in ("louvain_shard_local", "leiden_shard_local",
                    "louvain_halo8"):
            if rep[key]["bin_rank"] <= 0:
                fail(f"{what} {key} launched no bin_rank")
        log(f"[dist] (b) gloo rank {r}: graph built in {rep['load_s']:.2f} "
            f"s; " + ", ".join(
                f"{k} {v['wall_s']:.2f} s / bin_rank {v['bin_rank']}"
                for k, v in rep.items() if isinstance(v, dict)
                and "wall_s" in v) + f" ({card})")
    lv = ranks[0]["louvain_shard_local"]["result"]
    cs = lv["comm_stats"]
    log(f"[dist] (b) gloo x{DIST_RANKS} on one card: {wall_b:.2f} s from "
        f"spawn to the last exit; every rank equals (a) and the "
        f"single-device runs; halo_cap={DIST_HALO_CAP} degraded to "
        f"replicated with the same answer; shard_drop raised ShardError on "
        f"every rank ({card})")
    log(f"[dist] (b) shard-local comm: gathered groups per level "
        f"{cs['gathered_groups_per_level']}, actual bytes per level "
        f"{cs['actual_bytes_per_level']} against the model "
        f"{cs['bytes_per_level_model']}, halo labels {cs['halo_labels']}; "
        f"partition {lv['partition_stats']}; timer {lv['timer_s']}")
    total = time.perf_counter() - t0
    log(f"[dist] phase 3d {total:.2f} s ({card})")
    launches = sum(v["bin_rank"] for rep in [one] + ranks
                   for v in rep.values() if isinstance(v, dict)
                   and "bin_rank" in v)
    return {"single_louvain_s": s_lv, "single_leiden_s": s_ld,
            "nccl_x1": {k: {"wall_s": v["wall_s"], "bin_rank": v["bin_rank"]}
                        for k, v in one.items()},
            "gloo_ranks": [{k: ({"wall_s": v["wall_s"],
                                 "bin_rank": v["bin_rank"]}
                                if isinstance(v, dict) else v)
                            for k, v in rep.items()} for rep in ranks],
            "gloo_wall_s": wall_b, "comm_stats": cs,
            "partition_stats": lv["partition_stats"],
            "bin_rank_launches": launches, "total_s": total}


# ------------------------------------------------ phase 3c: batch and serve

SERVE_LOUVAIN_FIELDS = ("labels", "modularity", "levels", "n_communities",
                        "sweeps_per_level", "modularity_history",
                        "delta_n_per_level", "n_comm_per_level")


def egonets(rt, dev, count: int, seed: int):
    """The serving recipe's ego-net stand-ins, built on ``dev``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        n = int(rng.choice(SERVE_SIZES))
        k = int(rng.integers(3, 6))
        u, v, _w, _t = rt.sbm(n, k, p_in=0.35, p_out=0.03,
                              seed=seed + SERVE_SEED_STRIDE * i)
        out.append(rt.from_numpy_edges(u, v, n=n, device=dev))
    return out


def skewed_routing(n_tokens, n_experts, top_k, n_latent, seed=0):
    """tests/test_expert_placement.py's routing recipe: each token draws
    its top-k from one latent topic's experts (80 %) or uniformly."""
    import numpy as np

    rng = np.random.default_rng(seed)
    topic_of_expert = rng.integers(0, n_latent, n_experts)
    pools = [np.where(topic_of_expert == t)[0] for t in range(n_latent)]
    out = np.zeros((n_tokens, top_k), np.int32)
    for i in range(n_tokens):
        pool = pools[rng.integers(0, n_latent)]
        if rng.random() < 0.2 or pool.size < top_k:
            out[i] = rng.choice(n_experts, top_k, replace=False)
        else:
            out[i] = rng.choice(pool, top_k, replace=pool.size < top_k)
    return out


def _latency_ms(responses) -> dict:
    import numpy as np

    lat = np.array([r.latency_s for r in responses]) * 1e3
    return {"min": float(lat.min()), "median": float(np.median(lat)),
            "max": float(lat.max())}


def _timer_split(results) -> dict:
    """The results' timer entries summed over the graphs (s)."""
    out: dict = {}
    for r in results:
        for k, v in r.timer.totals.items():
            if "/" not in k:
                out[k] = round(out.get(k, 0.0) + v, 4)
    return out


def _watchdog_workers(before):
    """The watchdog worker threads started since ``before``."""
    return [t for t in threading.enumerate()
            if t not in before and t.name == "repro-watchdog-worker"]


def phase_serve(torch, rt, card: str):
    """The batched engine on ego-net traffic through the kernels, its
    parity with the single-graph runs and the ``ell`` batch, its rate
    against the single-graph loop, the service (clean, a transient failure, a stalled dispatch) and
    expert placement, on the card."""
    import numpy as np

    dev = torch.device("cuda")
    out = {"card": card}
    lcfg = rt.LouvainConfig(backend="pallas")
    pcfg = rt.PLPConfig(backend="pallas")
    lm, agg = rt.lm_kernel, rt.agg_kernel
    counters = {"local_move_plp": lm.local_move_plp_kernel,
                "local_move_louvain": lm.local_move_louvain_kernel,
                "bin_rank": agg.bin_rank_kernel,
                "local_move_plp_streamed": lm.local_move_plp_streamed_kernel,
                "local_move_louvain_streamed":
                    lm.local_move_louvain_streamed_kernel}

    # ego-net traffic on the kernels
    t = time.perf_counter()
    gs = egonets(rt, dev, SERVE_EGONETS, 0)
    torch.cuda.synchronize()
    sigs = sorted({tuple(rt.capacity_signature(g.n_max, g.m_max))[:3]
                   for g in gs})
    log(f"[serve] {len(gs)} ego-nets on the card in "
        f"{time.perf_counter() - t:.2f} s: n {min(g.n_max for g in gs)}.."
        f"{max(g.n_max for g in gs)}, directed edges "
        f"{min(g.m_valid for g in gs)}..{max(g.m_valid for g in gs)}; "
        f"signatures (n_cap, m_cap, W) {sigs}")
    unsorted = rt.telemetry.get("batch.unsorted_segment_fallback")
    for c in counters.values():
        c.launches = 0
    lv, lv_wall = timed_run(torch, lambda: rt.louvain_batch(gs, lcfg))
    pl, pl_wall = timed_run(torch, lambda: rt.plp_batch(gs, pcfg))
    launches = {k: c.launches for k, c in counters.items()}
    binned = sum(r.aggregation_per_level.count("binned") for r in lv)
    out["launches"] = launches
    log(f"[serve] wave 0: louvain_batch(pallas) {lv_wall:.2f} s, "
        f"plp_batch(pallas) {pl_wall:.2f} s; launches {launches}; binned "
        f"coarsenings {binned}; levels "
        f"{sorted(set(r.levels for r in lv))}")
    if not (launches["local_move_louvain"] > 0
            and launches["local_move_plp"] > 0):
        fail(f"[serve] the batch did not launch local_move: {launches}")
    if launches["local_move_plp_streamed"] \
            or launches["local_move_louvain_streamed"]:
        fail(f"[serve] a streamed kernel launched on traced tiles: "
             f"{launches}")
    if launches["bin_rank"] != binned:
        fail(f"[serve] bin_rank launched {launches['bin_rank']} times for "
             f"{binned} binned coarsenings")
    if rt.telemetry.get("batch.unsorted_segment_fallback") != unsorted:
        fail("[serve] batch.unsorted_segment_fallback moved")
    for r in lv + pl:
        rep = r.run_report
        if rep.degradations or rep.retries or rep.faults:
            fail(f"[serve] a lane's report is not clean: {rep.as_dict()}")

    # parity on the card: each lane ≡ the single-graph pallas run ≡ the
    # ell batch
    seq_l, seq_l_wall = timed_run(torch, lambda: [rt.louvain(g, lcfg)
                                                  for g in gs])
    seq_p, seq_p_wall = timed_run(torch, lambda: [rt.plp(g, pcfg)
                                                  for g in gs])
    lv_ell = rt.louvain_batch(gs, rt.LouvainConfig(backend="ell"))
    pl_ell = rt.plp_batch(gs, rt.PLPConfig(backend="ell"))
    for i in range(len(gs)):
        for ref, what in ((seq_l[i], "louvain(pallas)"),
                          (lv_ell[i], "louvain_batch(ell)")):
            compare_runs(lv[i], ref, SERVE_LOUVAIN_FIELDS,
                         f"[serve] ego-net {i}: louvain_batch(pallas) and "
                         f"{what}")
        for ref, what in ((seq_p[i], "plp(pallas)"),
                          (pl_ell[i], "plp_batch(ell)")):
            compare_runs(pl[i], ref, PLP_FIELDS,
                         f"[serve] ego-net {i}: plp_batch(pallas) and "
                         f"{what}")
    log(f"[serve] every lane of both batches equals its single-graph "
        f"pallas run and the ell batch in labels, Q, levels, communities, "
        f"sweeps and every history; single-graph loops: louvain "
        f"{seq_l_wall:.2f} s, plp {seq_p_wall:.2f} s")

    # batched against sequential graphs per second, on a second wave
    gs2 = egonets(rt, dev, SERVE_EGONETS, 1)
    lv2, lv2_wall = timed_run(torch, lambda: rt.louvain_batch(gs2, lcfg))
    pl2, pl2_wall = timed_run(torch, lambda: rt.plp_batch(gs2, pcfg))
    seq_l2, seq_l2_wall = timed_run(torch, lambda: [rt.louvain(g, lcfg)
                                                    for g in gs2])
    seq_p2, seq_p2_wall = timed_run(torch, lambda: [rt.plp(g, pcfg)
                                                    for g in gs2])
    for i in range(len(gs2)):
        compare_runs(lv2[i], seq_l2[i], SERVE_LOUVAIN_FIELDS,
                     f"[serve] wave 1 ego-net {i}: louvain batch and single")
        compare_runs(pl2[i], seq_p2[i], PLP_FIELDS,
                     f"[serve] wave 1 ego-net {i}: plp batch and single")
    n2 = len(gs2)
    rates = {"louvain_batched_gps": n2 / lv2_wall,
             "louvain_sequential_gps": n2 / seq_l2_wall,
             "plp_batched_gps": n2 / pl2_wall,
             "plp_sequential_gps": n2 / seq_p2_wall}
    splits = {"louvain_batched": _timer_split(lv2),
              "louvain_sequential": _timer_split(seq_l2),
              "plp_batched": _timer_split(pl2),
              "plp_sequential": _timer_split(seq_p2)}
    out.update(rates, timer_s=splits)
    log(f"[serve] wave 1 (seed 1): graphs/s on {card}: louvain batched "
        f"{rates['louvain_batched_gps']!r} ({lv2_wall:.3f} s) vs sequential "
        f"{rates['louvain_sequential_gps']!r} ({seq_l2_wall:.3f} s); plp "
        f"batched {rates['plp_batched_gps']!r} ({pl2_wall:.3f} s) vs "
        f"sequential {rates['plp_sequential_gps']!r} ({seq_p2_wall:.3f} s)")
    log(f"[serve] wave 1 timers summed over the graphs (s): {splits}")

    # the service: the reference smoke's traffic, clean
    ladder = ("serve.batch_fallback_sequential",
              "serve.breaker_routed_sequential")
    ladder0 = {k: rt.telemetry.get(k) for k in ladder}
    eng = rt.CommunityServeEngine(lcfg, pcfg, max_batch=8, max_retries=2,
                                  device=dev)
    reqs = rt.smoke_requests(12, 60000.0)
    for c in counters.values():
        c.launches = 0
    for r in reqs:
        if eng.submit(r) is not None:
            fail(f"[serve] request {r.request_id} was not accepted")
    resp, wall = timed_run(torch, eng.flush)
    flush_launches = {k: c.launches for k, c in counters.items()}
    widths = sorted({r.signature[2] for r in resp if r.signature})
    for req, r in zip(reqs, resp):
        if not r.ok or r.request_id != req.request_id:
            fail(f"[serve] request {req.request_id}: {r.error}")
        g = rt.from_numpy_edges(req.u, req.v, n=req.n, device=dev)
        if req.algo == "louvain":
            compare_runs(r.result, rt.louvain(g, lcfg), SERVE_LOUVAIN_FIELDS,
                         f"[serve] service {req.request_id} and louvain")
        else:
            compare_runs(r.result, rt.plp(g, pcfg), PLP_FIELDS,
                         f"[serve] service {req.request_id} and plp")
    moved = {k: rt.telemetry.get(k) - ladder0[k] for k in ladder}
    if any(moved.values()) or any(rt.telemetry.get(k) for k in ladder):
        fail(f"[serve] clean traffic took the sequential ladder: {moved}")
    out["service"] = {"flush_s": wall, "latency_ms": _latency_ms(resp),
                      "widths": widths, "launches": flush_launches,
                      "dispatches": eng.stats()["dispatches"]}
    log(f"[serve] service: 12 requests on {eng.device}, one flush "
        f"{wall:.3f} s, {eng.stats()['dispatches']} dispatches, tile widths "
        f"{widths}; latency ms {out['service']['latency_ms']}; launches "
        f"{flush_launches}; every response ok and equal to its "
        f"single-graph run; sequential ladder {moved}")

    # one transient batch failure: retried, every request ok
    retries = rt.telemetry.get("serve.retry")
    for r in reqs:
        eng.submit(r)
    rt.faultinject.arm("transient_batch_fail")
    rt.faultinject.set_fuel("transient_batch_fail", 1)
    try:
        resp, wall = timed_run(torch, eng.flush)
    finally:
        rt.faultinject.disarm("transient_batch_fail")
    retried = rt.telemetry.get("serve.retry") - retries
    if not all(r.ok for r in resp) or retried < 1:
        fail(f"[serve] under transient_batch_fail: ok "
             f"{sum(r.ok for r in resp)}/{len(resp)}, serve.retry +{retried}")
    out["service"]["transient"] = {"flush_s": wall, "retries": retried,
                                   "latency_ms": _latency_ms(resp)}
    log(f"[serve] under transient_batch_fail (fuel 1): every request ok, "
        f"serve.retry +{retried}, flush {wall:.3f} s")

    # last: a stalled dispatch past two requests' deadlines
    env = os.environ.get(rt.faultinject.SLOW_DISPATCH_ENV)
    os.environ[rt.faultinject.SLOW_DISPATCH_ENV] = str(SERVE_STALL_S)
    before = set(threading.enumerate())
    # two louvain requests of one signature: one batched dispatch
    for r in rt.smoke_requests(6, SERVE_DEADLINE_MS, seed=1)[1::4]:
        eng.submit(r)
    try:
        with rt.faultinject.inject("slow_dispatch"):
            t = time.perf_counter()
            resp = eng.flush()
            answered = time.perf_counter() - t
    finally:
        if env is None:
            os.environ.pop(rt.faultinject.SLOW_DISPATCH_ENV)
        else:
            os.environ[rt.faultinject.SLOW_DISPATCH_ENV] = env
    # the abandoned worker sleeps out its stall, then runs its batch on the
    # card: wait for it, so its launches land in no other phase
    t = time.perf_counter()
    workers = _watchdog_workers(before)
    for w in workers:
        w.join()
    torch.cuda.synchronize()
    waited = time.perf_counter() - t
    if len(resp) != 2 or any(r.ok or "DeadlineError" not in r.error
                             for r in resp):
        fail(f"[serve] stalled requests: {[(r.ok, r.error) for r in resp]}")
    if answered > SERVE_ANSWER_S:
        fail(f"[serve] stalled requests answered in {answered:.2f} s")
    out["service"]["deadline"] = {"answered_s": answered,
                                  "abandoned_workers": len(workers),
                                  "waited_s": waited}
    log(f"[serve] {SERVE_STALL_S:.0f} s stall, {SERVE_DEADLINE_MS:.0f} ms "
        f"deadlines: both requests answered DeadlineError in "
        f"{answered:.3f} s; waited {waited:.2f} s for {len(workers)} "
        f"abandoned worker(s)")

    # expert placement at the MoE router's shape
    pc = PLACEMENT
    t = time.perf_counter()
    routing = skewed_routing(pc["tokens"], pc["experts"], pc["top_k"],
                             pc["topics"])
    g = rt.coactivation_graph(routing, pc["experts"], device=dev)
    placement, place_wall = timed_run(torch, lambda: rt.louvain_placement(
        g, pc["experts"], pc["groups"]))
    counts = np.bincount(placement, minlength=pc["groups"])
    t_louv = rt.placement_traffic(routing, placement, pc["groups"])
    t_rand = rt.placement_traffic(
        routing, rt.random_placement(pc["experts"], pc["groups"]),
        pc["groups"])
    if counts.max() - counts.min() > 1 or not t_louv < t_rand:
        fail(f"[serve] placement: group sizes {counts.tolist()}, traffic "
             f"{t_louv!r} against random {t_rand!r}")
    out["placement"] = {"traffic": t_louv, "random_traffic": t_rand,
                        "edges": g.m_valid, "louvain_s": place_wall,
                        "group_sizes": counts.tolist()}
    log(f"[serve] expert placement: {pc['experts']} experts, top-"
        f"{pc['top_k']}, {pc['tokens']} tokens, {pc['groups']} groups; "
        f"co-activation graph {g.m_valid} directed edges "
        f"({time.perf_counter() - t:.2f} s in all, louvain_placement "
        f"{place_wall:.3f} s); cross-group share {t_louv!r} against random "
        f"{t_rand!r}; group sizes {counts.tolist()}")
    return out


# ------------------------------------------------ phase 3b: two-step scoring


def plp_tiles(rt, rows, nbr, labels_ext, n):
    """The two-step path's gather for PLP, as benchmarks/perf_variants.py's
    plp_two_step gathers: (neighbour labels, current labels, noise keys)."""
    g = rt.lm_ref._gather
    return (g(labels_ext, nbr, n, n), g(labels_ext, rows, n, n),
            rt.torch.where(rows < n, rows, n))


def louvain_tiles(rt, rows, nbr, composed, n):
    """The two-step path's gather for Louvain, as perf_variants.py's
    louvain_two_step gathers, from the composed per-vertex tables:
    (cand, cur, deg, vol_cand, vol_cur, size_cand, size_cur)."""
    g = rt.lm_ref._gather
    com, vol, size, deg = composed
    return (g(com, nbr, n, n), g(com, rows, n, n), g(deg, rows, n, 0.0),
            g(vol, nbr, n, 0.0), g(vol, rows, n, 0.0), g(size, nbr, n, 0),
            g(size, rows, n, 0))


def plp_two_step(rt, tiles, w, seed, kw):
    lab, cur, keys = tiles
    best, bs, cs = rt.la_ops.label_argmax(
        lab, w, cur, keys, seed, tie_eps=kw["tie_eps"],
        sentinel=kw["sentinel"], use_pallas=True)
    return best, (best >= 0) & (bs > cs)


def louvain_two_step(rt, tiles, w, vol_total, kw):
    cand, cur, deg, volc, volcur, sizec, sizecur = tiles
    best, gain = rt.dq_ops.delta_q_argmax(
        cand, w, cur, deg, volc, volcur, sizec, sizecur, vol_total,
        sentinel=kw["sentinel"], singleton_rule=kw["singleton_rule"],
        use_pallas=True)
    return best, (best >= 0) & (gain > 0.0)


def segment_sum_checks(torch, rt, graphs):
    """The GroupBy reduce of the path through ``sorted_segment_sum``: the
    R-MAT graph's weighted degrees from its src-sorted edges, and the
    community-rich graph's first-level community volumes from its edges
    sorted by the source's community; each must equal the main path's own
    (``Graph.weighted_degrees``, ``moves.community_aux``) bit for bit (the
    weights are integers).  Returns the inputs per graph for phase 4."""
    inputs = {}
    g = graphs[MAIN_GRAPH[0]][0]
    if g.sorted_by != "src":
        fail(f"{MAIN_GRAPH[0]} is not src-sorted")
    keys, vals = g.src, torch.where(g.edge_mask, g.w, 0.0)
    sums, starts = rt.ss_ops.sorted_segment_sum(keys, vals, use_pallas=True)
    deg = torch.zeros(g.n_max + 1, dtype=torch.float32, device=keys.device)
    deg[keys[starts].long()] = sums[starts]
    if not torch.equal(deg[:g.n_max], g.weighted_degrees()):
        fail(f"sorted_segment_sum: {MAIN_GRAPH[0]}'s degrees differ from "
             f"Graph.weighted_degrees()")
    inputs[MAIN_GRAPH[0]] = (keys, vals, "edge sources")

    g = graphs[COMMUNITY_GRAPH[0]][0]
    first = rt.louvain(g, rt.LouvainConfig(backend="pallas", max_levels=1))
    com = torch.as_tensor(first.labels, device=g.device).to(torch.int32)
    src, w = g.src[g.edge_mask], g.w[g.edge_mask]
    ckeys, order = torch.sort(com[src.long()], stable=True)
    cvals = w[order]
    sums, starts = rt.ss_ops.sorted_segment_sum(ckeys, cvals, use_pallas=True)
    vol = torch.zeros(g.n_max, dtype=torch.float32, device=g.device)
    vol[ckeys[starts].long()] = sums[starts]
    ref_vol, _ = rt.moves.community_aux(com, g.weighted_degrees(),
                                        g.vertex_mask(), g.n_max)
    if not torch.equal(vol, ref_vol):
        fail(f"sorted_segment_sum: {COMMUNITY_GRAPH[0]}'s first-level "
             f"community volumes differ from community_aux")
    inputs[COMMUNITY_GRAPH[0]] = (ckeys, cvals, "first-level communities "
                                  "of the edge sources")
    log(f"[two_step] sorted_segment_sum: {MAIN_GRAPH[0]} degrees over "
        f"{keys.numel()} src-sorted edge slots and {COMMUNITY_GRAPH[0]} "
        f"volumes of {first.n_communities} first-level communities over "
        f"{ckeys.numel()} edges equal the main path's, bit for bit")
    return inputs


def phase_two_step(args, torch, rt, recs, graphs):
    """Phase 3b: the two-step scoring path (gather the (rows, W) tiles
    outside a kernel, then score them with ``label_argmax`` /
    ``delta_q_argmax``), which the fused local_move kernels replaced, on
    every non-empty level-0 bucket of both graphs, the first and the last
    recorded sweep of PLP and Louvain, under unit, integer (1..8) and
    uniform float32 weights: its ``(best, propose)`` must equal the fused
    kernel's (the one the main path ran on that bucket) bit for bit.  Then
    the GroupBy reduce through ``sorted_segment_sum``.  The three new
    kernels' launch counters are set to 0 just before this path and read
    just after it.  Last, per bucket (last sweep, unit weights), the fused
    kernel's device time against the two-step's gather (CUDA events) plus
    its scoring kernel's device time."""
    rec_plp, rec_lv, _, rec_plp_s, rec_lv_s = recs
    counters = (rt.la_kernel.label_argmax_kernel, rt.dq_kernel.delta_q_kernel,
                rt.ss_kernel.block_segment_sums_kernel)
    captured = {"label_argmax": {}, "delta_q": {}}
    buckets = []
    for c in counters:
        c.launches = 0
    for algo, algo_recs in (("plp", (rec_plp, rec_plp_s)),
                            ("louvain", (rec_lv, rec_lv_s))):
        for rec in algo_recs:
            for (graph, level, width), (first, last) in sorted(
                    rec.calls.items()):
                if level:
                    continue          # level-0 buckets only
                g = graphs[graph][0]
                n = g.n_max
                for tag, (a, kw) in (("first", first), ("last", last)):
                    rows, nbr, w, *rest = a
                    if algo == "plp":
                        tiles = plp_tiles(rt, rows, nbr, rest[0], n)
                        vol_total = None
                    else:
                        tiles = louvain_tiles(rt, rows, nbr, rest[:4], n)
                        vol_total = g.total_volume()
                        if not torch.equal((1.0 / vol_total).to(torch.float32),
                                           rest[4]):
                            fail("the main path's 1/vol(V) is not "
                                 "(1 / total_volume()) in float32")
                    for wname, ww in weightings(w, torch, width):
                        fused = rec.fn(rows, nbr, ww, *rest, **kw)
                        two = (plp_two_step(rt, tiles, ww, rest[1], kw)
                               if algo == "plp" else
                               louvain_two_step(rt, tiles, ww, vol_total, kw))
                        if not (torch.equal(two[0], fused[0])
                                and torch.equal(two[1], fused[1])):
                            fail(f"two-step {algo} {graph} W={width} ({tag} "
                                 f"sweep, {wname} weights) differs from the "
                                 f"fused kernel")
                    if tag == "last":
                        buckets.append((algo, rec, graph, width, a, kw,
                                        tiles, vol_total))
    seg_inputs = segment_sum_checks(torch, rt, graphs)
    launches = {c.__name__.replace("_kernel", ""): c.launches
                for c in counters}
    log(f"[two_step] every level-0 bucket of both graphs, first and last "
        f"sweep, unit/int1..8/f32 weights: two-step ≡ fused bit for bit; "
        f"launches {launches}")
    for name, count in launches.items():
        if count <= 0:
            fail(f"kernel {name} was launched no time on the two-step path")

    reps = args.reps
    report = {}
    for algo, rec, graph, width, a, kw, tiles, vol_total in buckets:
        rows, nbr, w, *rest = a
        n = graphs[graph][0].n_max
        if algo == "plp":
            def gather():
                return plp_tiles(rt, rows, nbr, rest[0], n)
            lab, cur, keys = tiles
            s_args = (lab, w, cur, keys, rest[1])
            s_kw = dict(tie_eps=kw["tie_eps"], sentinel=n)
            score = rt.la_kernel.label_argmax_kernel
        else:
            def gather():
                return louvain_tiles(rt, rows, nbr, rest[:4], n)
            cand, cur, deg, volc, volcur, sizec, sizecur = tiles
            s_args = (cand, w, cur, deg, volc, volcur, sizec, sizecur,
                      rest[4])
            s_kw = dict(sentinel=n, singleton_rule=kw["singleton_rule"])
            score = rt.dq_kernel.delta_q_kernel
        captured["label_argmax" if algo == "plp" else "delta_q"][
            (graph, width)] = (s_args, s_kw)
        fused_ms = device_ms(lambda: rec.fn(rows, nbr, w, *rest, **kw), reps,
                             torch)
        gather_ms = loop_ms(gather, reps, torch)
        score_ms = device_ms(lambda: score(*s_args, **s_kw), reps, torch)
        two_ms = gather_ms + score_ms
        rec_out = {"width": width, "rows": int(rows.shape[0]),
                   "rows_real": int((rows < n).sum()),
                   "fused_kernel": rec.fn.__name__.replace("_kernel", ""),
                   "fused_s": fused_ms / 1e3, "two_step_s": two_ms / 1e3,
                   "gather_s": gather_ms / 1e3, "scoring_s": score_ms / 1e3,
                   "fused_speedup_vs_two_step": two_ms / fused_ms,
                   "bit_identical": True}
        report.setdefault((graph, algo), []).append(rec_out)
        log(f"[two_step] {graph} {algo} W={width} rows={rec_out['rows']}: "
            f"fused {fused_ms:.4f} ms ({rec_out['fused_kernel']}), two-step "
            f"{two_ms:.4f} ms (gather {gather_ms:.4f} + scoring "
            f"{score_ms:.4f}), two-step / fused {two_ms / fused_ms:.2f}")
    out = []
    for (graph, algo), per_width in sorted(report.items()):
        fused = sum(r["fused_s"] for r in per_width)
        two = sum(r["two_step_s"] for r in per_width)
        line = {"mode": "gather_fusion", "dataset": graph,
                f"{algo}_per_width": per_width,
                f"{algo}_kernel_fused_s": fused,
                f"{algo}_kernel_two_step_s": two,
                f"{algo}_kernel_speedup_vs_two_step": two / fused,
                f"{algo}_bit_identical": True}
        log(json.dumps(line))
        out.append(line)
    return {"launches": launches, "gather_fusion": out}, captured, seg_inputs


def local_move_bytes(R: int, slots: int, entries: int) -> int:
    """Bytes a local_move function moves: the R row ids, the ids and
    weights of ``slots`` tile slots, ``entries`` 4-byte table entries,
    and the (R,) label/candidate and flag outputs once."""
    return 4 * R + 8 * slots + 4 * entries + 5 * R


def local_move_bound(rt, rows, nbr, w, n1: int, tables: tuple[int, int]):
    """(bound ms, bound_by, full-tile bound ms, tile counts) of one
    local_move call, after checking the tile contract
    (``graph/ell.py tile_contract``) on its tile.  Bytes: under the
    contract the function reads each row id, each live row's slots up to
    its last real one (``prefix_slots``), and the table entries it
    gathers, and writes its outputs.  ``tables = (a, b)``: a tables are
    read at the row ids and the neighbour ids, b at the row ids alone, in
    each case only at the distinct ids of the live rows that hold a real
    slot (a row with none moves nowhere, whatever the tables hold) and of
    their real neighbours (``table_ids``).  The full-tile bound counts
    every slot of every row and every table in full.  Operations: a
    weighted mode or gain argmax over a row's real entries needs no more
    than a sort (log2 W compares per entry) and a scan (one add and one
    compare per entry)."""
    R, W = nbr.shape
    sentinel = n1 - 1
    try:
        live, real, prefix, crowded = rt.tile_contract(rows, nbr, w,
                                                       sentinel)
    except ValueError as err:
        fail(f"a main-path tile ({R} x {W}) breaks the tile contract: {err}")
    real_slot = nbr < sentinel
    row_ids = rows[real_slot.any(dim=1)]
    seen = rows.new_zeros(n1).bool()
    seen[row_ids.long()] = True
    seen[nbr[real_slot].long()] = True
    ids = int(seen.sum())
    at_both, at_row = tables
    entries = at_both * ids + at_row * int(row_ids.numel())
    ops = real * (math.log2(W) + 2.0)
    nbytes = local_move_bytes(R, prefix, entries)
    b_ms, kind = bound_ms(nbytes, ops)
    full_ms, _ = bound_ms(local_move_bytes(R, R * W, sum(tables) * n1), ops)
    return b_ms, kind, full_ms, {"live_rows": live, "real_slots": real,
                                 "prefix_slots": prefix,
                                 "crowded_rows": crowded, "table_ids": ids,
                                 "bound_bytes": nbytes}


def check_equal(kernel, plain, a, kw, name, graph, width, tag, torch):
    """The kernel against its plain version on recorded arguments, with the
    unit weights and with integer weights 1..8; returns the max error."""
    rows, nbr, w, *rest = a
    err = 0.0
    for wname, ww in (("unit", w), ("int1..8", int_weights(w, torch, width))):
        ko = kernel(rows, nbr, ww, *rest, **kw)
        po = plain(rows, nbr, ww, *rest, **kw)
        torch.cuda.synchronize()
        e = max(max_abs_err(ko[0], po[0]), max_abs_err(ko[1], po[1]))
        if e != 0.0:
            fail(f"{name} {graph} W={width} ({tag} sweep, {wname} weights): "
                 f"kernel and plain differ")
        err = max(err, e)
    return err


def phase_kernels(args, torch, rt, recs, launches, coarse_launches):
    rec_plp, rec_lv, rec_bin, rec_plp_s, rec_lv_s = recs
    reps = args.reps
    rows_out = []

    def local_move(rec, name, kernel, plain, tables):
        """Compare on every recorded (graph, level, width) input and time
        the last call of each.  The totals sum the R-MAT graph's level-0
        buckets (one main-path sweep); the ``coarse`` totals sum its
        coarse levels' traced tiles (one sweep of each level); the
        full-tile bounds of both are logged."""
        total = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
        coarse = dict(total)
        full_tile = {0: 0.0, 1: 0.0}            # level 0, coarse levels
        err, bound_kinds, detail = 0.0, {"bytes": 0.0, "operations": 0.0}, []
        for (graph, level, width), (first, last) in sorted(rec.calls.items()):
            where = f"{graph} L{level}"
            for tag, (a, kw) in (("first", first), ("last", last)):
                err = max(err, check_equal(kernel, plain, a, kw, name, where,
                                           width, tag, torch))
            rows, nbr, w, *rest = last[0]
            kw = last[1]
            k_ms = device_ms(lambda: kernel(rows, nbr, w, *rest, **kw), reps,
                             torch)
            p_ms = loop_ms(lambda: plain(rows, nbr, w, *rest, **kw), reps,
                           torch)
            R, W = nbr.shape
            n1 = rest[0].shape[0]
            b_ms, kind, full_ms, counts = local_move_bound(
                rt, rows, nbr, w, n1, tables)
            if graph == MAIN_GRAPH[0]:
                into = total if level == 0 else coarse
                if level == 0:
                    bound_kinds[kind] += b_ms
                into["ms"] += k_ms
                into["plain_ms"] += p_ms
                into["bound_ms"] += b_ms
                full_tile[min(level, 1)] += full_ms
            detail.append({"graph": graph, "level": level, "width": W,
                           "rows": R, **counts, "ms": k_ms,
                           "plain_ms": p_ms,
                           "bound_ms": b_ms, "bound_by": kind})
            log(f"[kernels] {name} {graph} level {level} W={W} rows={R}: "
                f"live rows {counts['live_rows']}, real slots "
                f"{counts['real_slots']}, slots up to each live row's last "
                f"real one {counts['prefix_slots']} (of {R * W}), crowded "
                f"rows {counts['crowded_rows']}, table ids "
                f"{counts['table_ids']} (of {n1 - 1}); kernel "
                f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {b_ms:.4f} ms "
                f"({kind}, {counts['bound_bytes']} B; full tile "
                f"{full_ms:.4f} ms)")
        log(f"[kernels] {name} {MAIN_GRAPH[0]} totals: level 0 kernel "
            f"{total['ms']:.4f} ms, bound {total['bound_ms']:.4f} ms, full "
            f"tile {full_tile[0]:.4f} ms; coarse levels kernel "
            f"{coarse['ms']:.4f} ms, bound {coarse['bound_ms']:.4f} ms, "
            f"full tile {full_tile[1]:.4f} ms")
        total["coarse"] = coarse
        return total, err, bound_kinds, detail

    def streamed_local_move(rec, name, kernel, plain, resident, tables):
        """Compare on every recorded (graph, width) input; time the streamed
        kernel, the resident kernel on the same bucket and the plain
        version; the totals sum every streamed bucket (com-dblp's)."""
        total = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                 "resident_ms": 0.0}
        err, bound_kinds, detail = 0.0, {"bytes": 0.0, "operations": 0.0}, []
        if not rec.calls:
            fail(f"{name} recorded no main-path call")
        for (graph, _, width), (first, last) in sorted(rec.calls.items()):
            for tag, (a, kw) in (("first", first), ("last", last)):
                err = max(err, check_equal(kernel, plain, a, kw, name, graph,
                                           width, tag, torch))
            rows, nbr, w, *rest = last[0]
            kw = last[1]
            win = kw["windows"]
            rkw = {k: v for k, v in kw.items() if k != "windows"}
            k_ms = device_ms(lambda: kernel(rows, nbr, w, *rest, **kw), reps,
                             torch)
            r_ms = device_ms(lambda: resident(rows, nbr, w, *rest, **rkw),
                             reps, torch)
            p_ms = loop_ms(lambda: plain(rows, nbr, w, *rest, **kw), reps,
                           torch)
            R, W = nbr.shape
            n1 = rest[0].shape[0]
            b_ms, kind, full_ms, counts = local_move_bound(
                rt, rows, nbr, w, n1, tables)
            nb = int(win.win_blk.numel())
            # the same bucket re-blocked: how the block size trades blocks
            # against window bytes (the main path runs win.block_rows)
            ref_out = kernel(rows, nbr, w, *rest, **kw)
            sweep = {}
            for br in STREAM_BLOCK_ROWS_SWEEP:
                kb = dict(kw, windows=rt.compute_windows(rows, nbr, n1 - 1,
                                                         br))
                out = kernel(rows, nbr, w, *rest, **kb)
                if not (torch.equal(out[0], ref_out[0])
                        and torch.equal(out[1], ref_out[1])):
                    fail(f"{name} {graph} W={W}: {br} rows per block "
                         f"changed the result")
                sweep[br] = {"ms": device_ms(
                    lambda: kernel(rows, nbr, w, *rest, **kb), reps, torch),
                    "slot": kb["windows"].slot}
            log(f"[kernels] {name} {graph} W={W} by rows per block: "
                + ", ".join(f"{br}: {v['ms']:.4f} ms (slot {v['slot']})"
                            for br, v in sweep.items()))
            read = (local_move_bytes(R, R * W, 0)
                    + nb * 2 * win.slot * 4 * sum(tables))
            bound_kinds[kind] += b_ms
            total["ms"] += k_ms
            total["resident_ms"] += r_ms
            total["plain_ms"] += p_ms
            total["bound_ms"] += b_ms
            detail.append({"graph": graph, "width": W, "rows": R,
                           "blocks": nb, "block_rows": win.block_rows,
                           "slot": win.slot, "ms": k_ms, "resident_ms": r_ms,
                           "plain_ms": p_ms, "bound_ms": b_ms,
                           "bound_by": kind, **counts,
                           "streamed_bytes": read, "by_block_rows": sweep})
            log(f"[kernels] {name} {graph} W={W} rows={R} blocks={nb} "
                f"slot={win.slot}: streamed kernel {k_ms:.4f} ms, resident "
                f"kernel {r_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
                f"{b_ms:.4f} ms ({kind}; full tile {full_ms:.4f} ms); bytes: "
                f"the function's {detail[-1]['bound_bytes']}, the streamed "
                f"layout reads {read}")
        return total, err, bound_kinds, detail

    # tables read at the row and neighbour ids, and at the row ids alone:
    # PLP's labels; Louvain's com_v, volcom_v, sizecom_v, and deg_v
    plp_tables, lv_tables = (1, 0), (3, 1)
    plp_tot, plp_err, plp_kinds, plp_det = local_move(
        rec_plp, "local_move_plp", rec_plp.fn,
        rt.lm_ref.local_move_plp_ref, plp_tables)
    lv_tot, lv_err, lv_kinds, lv_det = local_move(
        rec_lv, "local_move_louvain", rec_lv.fn,
        rt.lm_ref.local_move_louvain_tables_ref, lv_tables)
    plp_s_tot, plp_s_err, plp_s_kinds, plp_s_det = streamed_local_move(
        rec_plp_s, "local_move_plp_streamed", rec_plp_s.fn,
        rt.lm_ref.local_move_plp_windowed_ref, rec_plp.fn, plp_tables)
    lv_s_tot, lv_s_err, lv_s_kinds, lv_s_det = streamed_local_move(
        rec_lv_s, "local_move_louvain_streamed", rec_lv_s.fn,
        rt.lm_ref.local_move_louvain_windowed_ref, rec_lv.fn, lv_tables)

    if not rec_bin.calls:
        fail("bin_rank recorded no main-path call")
    bin_graph = next(iter(rec_bin.calls))   # the first graph that launched it
    # the launch floor: a one-element add_, timed as the kernel is
    one = torch.zeros(1, device=rec_bin.calls[bin_graph][0][0][0].device)
    floor_ms = device_ms(lambda: one.add_(1), reps, torch)
    bin_err, bin_det = 0.0, []
    for tag, (a, kw) in zip(("first", "last"), rec_bin.calls[bin_graph]):
        keys, cs, cd = a
        ko = rec_bin.fn(keys, cs, cd, **kw)
        po = rt.agg_ref.bin_rank_ref(keys, cs, cd, **kw)
        torch.cuda.synchronize()
        bin_err = max(bin_err, max_abs_err(ko, po))
        if bin_err != 0.0:
            fail(f"bin_rank ({tag} call): kernel and plain differ")
        b_k = device_ms(lambda: rec_bin.fn(keys, cs, cd, **kw), reps, torch)
        b_p = loop_ms(lambda: rt.agg_ref.bin_rank_ref(keys, cs, cd, **kw),
                      reps, torch)
        m, W = cs.shape[0], kw["width"]
        # bytes: cs, cd and the rank output once each, and the bin rows
        # the edges name (this level's communities, plus the sink row of
        # the masked edges) — not the whole (n+1)-row table, most of whose
        # rows belong to no community at a late level.  Operations: a
        # binary search per edge in a sorted row, and the rows' sort.
        rows_read = int(torch.unique(cs).numel())
        b_b, b_kind = bound_ms(12 * m + 4 * W * rows_read,
                               (m + rows_read * W) * math.log2(W))
        bin_det.append({"graph": bin_graph, "call": tag, "width": W,
                        "edges": m, "rows_read": rows_read, "ms": b_k,
                        "plain_ms": b_p, "bound_ms": b_b, "bound_by": b_kind,
                        "floor_ms": floor_ms})
        log(f"[kernels] bin_rank {bin_graph} ({tag} call) W={W} edges={m} "
            f"rows read {rows_read}: kernel {b_k:.4f} ms, plain {b_p:.4f} "
            f"ms, bound {b_b:.4f} ms ({b_kind}), launch floor (one-element "
            f"add_) {floor_ms:.4f} ms")
    bin_row = bin_det[0]         # the first call, as earlier runs logged

    def row(name, source, replaces, tot, err, kinds, detail):
        out = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": launches[name],
               "max_abs_err": err, "ms": tot["ms"], "kernel_ms": tot["ms"],
               "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
               "bound_by": max(kinds, key=kinds.get),
               "library_ms": None, "equal": err == 0.0, "per_width": detail}
        if "resident_ms" in tot:
            out["resident_ms"] = tot["resident_ms"]
        if "coarse" in tot:
            # the same kernel on the R-MAT graph's coarse levels (traced
            # tiles, one sweep of each level), a sub-row of its own
            out["coarse_levels"] = dict(
                tot["coarse"],
                launches=coarse_launches[MAIN_GRAPH[0]].get(name, 0))
        return out

    rows_out.append(row(
        "local_move_plp", "src/repro_torch/kernels/csrc/local_move_plp.cu",
        "src/repro/kernels/local_move/kernel.py:192", plp_tot, plp_err,
        plp_kinds, plp_det))
    rows_out.append(row(
        "local_move_louvain",
        "src/repro_torch/kernels/csrc/local_move_louvain.cu",
        "src/repro/kernels/local_move/kernel.py:386", lv_tot, lv_err,
        lv_kinds, lv_det))
    rows_out.append(row(
        "local_move_plp_streamed",
        "src/repro_torch/kernels/csrc/local_move_plp_streamed.cu",
        "src/repro/kernels/local_move/kernel.py:245", plp_s_tot, plp_s_err,
        plp_s_kinds, plp_s_det))
    rows_out.append(row(
        "local_move_louvain_streamed",
        "src/repro_torch/kernels/csrc/local_move_louvain_streamed.cu",
        "src/repro/kernels/local_move/kernel.py:451", lv_s_tot, lv_s_err,
        lv_s_kinds, lv_s_det))
    rows_out.append(row(
        "bin_rank", "src/repro_torch/kernels/csrc/bin_rank.cu",
        "src/repro/kernels/aggregation/kernel.py:62", bin_row, bin_err,
        {bin_row["bound_by"]: bin_row["bound_ms"]}, bin_det))
    rows_out[-1]["floor_ms"] = floor_ms
    return rows_out


def check_tiles_f32(name, plain, args, sentinel, out_k, out_p, where, torch):
    """Kernel against plain version on float32 weights.  The plain version
    adds a row with ``torch.sum`` (its own order), the kernel in ascending
    position order, so a score may differ by the rounding of a sum of up
    to W terms, which scales with the terms added — the row's weight mass
    M = Σ|w| — not with the score: a ΔQ gain is a difference of two such
    sums (S − S_A) and may be far smaller than either.  So scores agree
    within 1e-5·max(1, M) per row, and labels wherever the plain version's
    top two scores differ by more than twice that.  The runner-up is the
    plain version's best once the best label's entries are masked out (no
    other label's score depends on them).  On the other rows (near ties)
    the kernel's label must still be a candidate whose plain score lies
    within 2e-5·M of the plain best: the plain version run on the row with
    only that label's entries kept (and, for ``delta_q``, the current
    community's, on which every gain depends) must return that label with
    such a score.  Logs the near-tie rows and the largest score error
    against M and against the score itself; returns the largest absolute
    error and the near-tie row count."""
    mass = args[1].abs().sum(dim=1).clamp_min(1.0)
    err_mass = err_score = 0.0
    for a, b in zip(out_k[1:], out_p[1:]):
        diff = torch.where(a == b, 0.0, (a - b).abs())
        if not bool((diff <= 1e-5 * mass).all()):
            fail(f"{name} {where} (f32 weights): scores differ by more than "
                 f"1e-5 of the row's weight mass")
        err_mass = max(err_mass, float((diff / mass).max()))
        err_score = max(err_score, float(
            (diff / b.abs().clamp_min(1e-30)).max()))
    best = out_p[0]
    masked = torch.where(args[0] == best[:, None], sentinel, args[0])
    second = plain(masked, *args[1:])[1]
    decided = (best < 0) | ((out_p[1] - second).abs() > 2e-5 * mass)
    if not torch.equal(out_k[0][decided], best[decided]):
        fail(f"{name} {where} (f32 weights): labels differ where the plain "
             f"version's top two scores are more than 2e-5 of the row's "
             f"weight mass apart")
    near = ~decided
    n_near = int(near.sum())
    if n_near:
        sub = [x[near] if torch.is_tensor(x) and x.dim() else x for x in args]
        lab = out_k[0][near]
        keep = sub[0] == lab[:, None]
        if name == "delta_q":
            keep |= sub[0] == sub[2][:, None]
        only = plain(torch.where(keep, sub[0], sentinel), *sub[1:])
        ok = (only[0] == lab) & (
            only[1] >= out_p[1][near] - 2e-5 * mass[near])
        if not bool(ok.all()):
            fail(f"{name} {where} (f32 weights): on {int((~ok).sum())} "
                 f"near-tie rows the kernel's label is no candidate within "
                 f"2e-5 of the row's weight mass of the plain best")
    log(f"[kernels] {name} {where} f32 weights: {n_near} near-tie rows of "
        f"{best.numel()}, the kernel's label within 2e-5 of the row's "
        f"weight mass of the plain best on each, labels equal on the rest; "
        f"largest score error {err_mass:.3g} of the row's weight mass "
        f"({err_score:.3g} of the score)")
    return (max(max_abs_err(a, b) for a, b in zip(out_k[1:], out_p[1:])),
            n_near)


def phase_scored_tiles(args, torch, rt, captured, seg_inputs, launches):
    """Phase 4 for the two-step path's kernels: ``label_argmax`` and
    ``delta_q`` on the tiles phase 3b gathered (last sweep of every
    level-0 bucket of both graphs), ``block_segment_sums`` through
    ``sorted_segment_sum`` on phase 3b's sorted keys, each against its
    plain version — bit for bit on unit and integer weights, within the
    stated tolerance on float32 weights — then timed like the other rows.
    ``label_argmax``/``delta_q`` rows sum the R-MAT graph's four buckets."""
    reps = args.reps
    out = []
    specs = (
        ("label_argmax", rt.la_kernel.label_argmax_kernel,
         lambda a, kw: rt.la_ref.label_argmax_chunked(
             *a, kw["tie_eps"], kw["sentinel"]),
         "src/repro_torch/kernels/csrc/label_argmax.cu",
         "src/repro/kernels/label_argmax/kernel.py:67",
         lambda R, W: 8 * R * W + 8 * R + 12 * R),
        ("delta_q", rt.dq_kernel.delta_q_kernel,
         lambda a, kw: rt.dq_ref.delta_q_chunked(
             *a, kw["sentinel"], kw["singleton_rule"]),
         "src/repro_torch/kernels/csrc/delta_q.cu",
         "src/repro/kernels/delta_q/kernel.py:72",
         lambda R, W: 16 * R * W + 16 * R + 8 * R))
    for name, kernel, plain, source, replaces, nbytes in specs:
        total = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
        kinds, detail = {"bytes": 0.0, "operations": 0.0}, []
        err = f32_err = 0.0
        f32_rows = f32_near = 0
        for (graph, width), (s_args, s_kw) in sorted(captured[name].items()):
            where = f"{graph} W={width}"
            for wname, w in weightings(s_args[1], torch, width + 1):
                a = (s_args[0], w, *s_args[2:])
                ko, po = kernel(*a, **s_kw), plain(a, s_kw)
                torch.cuda.synchronize()
                if wname == "f32":
                    e, near = check_tiles_f32(
                        name, lambda *pa: plain(pa, s_kw), a,
                        s_kw["sentinel"], ko, po, where, torch)
                    f32_err = max(f32_err, e)
                    f32_rows += s_args[0].shape[0]
                    f32_near += near
                    continue
                if not all(torch.equal(x, y) for x, y in zip(ko, po)):
                    fail(f"{name} {where} ({wname} weights): kernel and "
                         f"plain differ")
                err = max([err] + [max_abs_err(x, y) for x, y in zip(ko, po)])
            R, W = s_args[0].shape
            k_ms = device_ms(lambda: kernel(*s_args, **s_kw), reps, torch)
            p_ms = loop_ms(lambda: plain(s_args, s_kw), reps, torch)
            b_ms, kind = bound_ms(nbytes(R, W), R * W * math.log2(W))
            if graph == MAIN_GRAPH[0]:
                kinds[kind] += b_ms
                total["ms"] += k_ms
                total["plain_ms"] += p_ms
                total["bound_ms"] += b_ms
            detail.append({"graph": graph, "width": W, "rows": R, "ms": k_ms,
                           "plain_ms": p_ms, "bound_ms": b_ms,
                           "bound_by": kind})
            log(f"[kernels] {name} {where} rows={R}: kernel {k_ms:.4f} ms, "
                f"plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({kind})")
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces, "launches": launches[name],
                    "max_abs_err": err, "f32_max_abs_err": f32_err,
                    "f32_rows": f32_rows, "f32_near_tie_rows": f32_near,
                    "ms": total["ms"],
                    "kernel_ms": total["ms"], "plain_ms": total["plain_ms"],
                    "bound_ms": total["bound_ms"],
                    "bound_by": max(kinds, key=kinds.get),
                    "library_ms": None, "equal": True, "per_width": detail})

    # block_segment_sums, through its entry point sorted_segment_sum
    ss = rt.ss_ops.sorted_segment_sum
    block = rt.ss_kernel.DEFAULT_BLOCK
    err, detail = 0.0, []
    for graph, (keys, vals, what) in seg_inputs.items():
        for wname, v in weightings(vals, torch, 5):
            ko = ss(keys, v, use_pallas=True)
            po = rt.ss_ref.sorted_segment_sum_ref(keys, v)
            torch.cuda.synchronize()
            if not torch.equal(ko[1], po[1]):
                fail(f"block_segment_sums {graph}: run starts differ")
            if wname == "f32":
                if not bool(torch.isclose(ko[0], po[0], rtol=1e-5,
                                          atol=1e-5).all()):
                    fail(f"block_segment_sums {graph} (f32 values): sums "
                         f"differ beyond rtol = atol = 1e-5")
                continue
            if not torch.equal(ko[0], po[0]):
                fail(f"block_segment_sums {graph} ({wname} values): kernel "
                     f"and plain differ")
        m = keys.numel()
        pad = (-m) % block
        kp = torch.cat([keys, keys.new_full((pad,), 2**31 - 1)])
        vp = torch.cat([vals, vals.new_zeros(pad)])
        k_ms = device_ms(lambda: rt.ss_kernel.block_segment_sums_kernel(
            kp, vp, block=block), reps, torch)
        # the entry point reads its run count back to the host (segment
        # lengths), so it is timed with that wait in it
        e_ms = loop_ms(lambda: ss(keys, vals, use_pallas=True), reps, torch)
        p_ms = loop_ms(lambda: rt.ss_ref.sorted_segment_sum_ref(keys, vals),
                       reps, torch)
        lengths_ms = loop_ms(lambda: torch.unique_consecutive(
            keys, return_counts=True), reps, torch)
        lengths = torch.unique_consecutive(keys, return_counts=True)[1]
        # unsafe=True, as graph/segment.py calls it: the checks of the
        # lengths read them back to the host
        lib_ms = device_ms(lambda: torch.segment_reduce(
            vals, "sum", lengths=lengths, unsafe=True), reps, torch)
        runs = int(lengths.numel())
        # the kernel reads 8 bytes a padded key and writes the 4-byte
        # totals; the entry point also writes the 1-byte run starts
        b_ms, kind = bound_ms(12 * kp.numel(), kp.numel())
        eb_ms, _ = bound_ms(13 * m, m)
        detail.append({"graph": graph, "keys": what, "m": m, "runs": runs,
                       "longest_run": int(lengths.max()), "ms": k_ms,
                       "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": kind,
                       "entry_ms": e_ms, "entry_bound_ms": eb_ms,
                       "library_ms": lib_ms, "lengths_ms": lengths_ms})
        log(f"[kernels] block_segment_sums {graph} ({what}) m={m} runs={runs} "
            f"longest {int(lengths.max())}: kernel {k_ms:.4f} ms (bound "
            f"{b_ms:.4f} ms, {kind}), sorted_segment_sum (kernel + spine) "
            f"{e_ms:.4f} ms (bound {eb_ms:.4f} ms), plain {p_ms:.4f} ms; "
            f"torch.segment_reduce {lib_ms:.4f} ms, its lengths "
            f"(unique_consecutive) {lengths_ms:.4f} ms")
    main = detail[0]
    out.append({"name": "block_segment_sums", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/block_segment_sums.cu",
                "replaces": "src/repro/kernels/segment_sum/kernel.py:31",
                "launches": launches["block_segment_sums"],
                "max_abs_err": err, "ms": main["ms"],
                "kernel_ms": main["ms"], "entry_ms": main["entry_ms"],
                "entry_bound_ms": main["entry_bound_ms"],
                "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
                "bound_by": main["bound_by"],
                "library_ms": main["library_ms"], "equal": True,
                "per_graph": detail})
    return out


# ------------------------------------------------------------ phase 5: LM


def attention_flops(q, k) -> float:
    """The causal half of both products: 2·B·Hq·Sq·Sk·D flops."""
    b, hq, sq, d = q.shape
    return 2.0 * b * hq * sq * k.shape[2] * d


def attention_bound(q, k) -> tuple[float, str]:
    """A flash kernel's least time: its products on the tensor cores (bf16
    at 989 TFLOP/s; float32 as three TF32 products each at 495 TFLOP/s),
    or q, k, v and o moved once each at HBM rate."""
    flops = attention_flops(q, k)
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    t_ops = (flops / BF16_TFLOPS if q.element_size() == 2
             else TF32_TERMS * flops / TF32_TFLOPS) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check_attention(rt, torch, q, k, v, causal, where) -> float:
    """Kernel against ``attention_ref`` on the same inputs; returns the
    largest absolute difference, or fails past the tolerance: in float32
    rtol = atol = 1e-5; in bf16 one bf16 ulp of the larger of the two
    values, plus 1e-6 — both sides keep the probabilities to float32
    precision and round to bf16 once, so they differ by that rounding at
    most."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = rt.fa_kernel.flash_attention_fwd_kernel(q, k, v, causal=causal)
    if torch.backends.cuda.matmul.allow_tf32:
        fail("torch.backends.cuda.matmul.allow_tf32 is on: attention_ref's "
             "float32 products would run in TF32")
    ref = rt.fa_ref.attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    a, b = out.float(), ref.float()
    name = rt.fa_kernel.KERNEL_OF[q.dtype]
    if not torch.isfinite(a).all():
        fail(f"{name} {where}: non-finite output")
    diff = (a - b).abs()
    if q.dtype == torch.float32:
        bad, tol = ~torch.isclose(a, b, rtol=1e-5, atol=1e-5), "1e-5"
    else:
        # frexp: |x| in [2^(e-1), 2^e); bf16 keeps 8 significant bits
        e = torch.frexp(torch.maximum(a.abs(), b.abs())).exponent
        bad = diff > torch.ldexp(torch.ones_like(a), e - 8) + 1e-6
        tol = "1 bf16 ulp + 1e-6"
    err = float(diff.max())
    if bad.any():
        fail(f"{name} {where}: {int(bad.sum())} of "
             f"{bad.numel()} outputs differ from attention_ref beyond {tol} "
             f"(max |difference| {err})")
    return err


def phase_lm(args, torch, rt):
    """The dense model's prefill and serving path at full width, with the
    flash kernels held against their plain version and timed."""
    import numpy as np

    dev = torch.device("cuda")
    c = rt.configs.get(LM_ARCH)
    model = rt.model_api.build(c)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    params = rt.init_params(model.decls, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    n_params = rt.param_count(params)
    n_norms = sum(p.numel() for k, p in params["layers"].items()
                  if k in ("ln1", "ln2", "q_norm", "k_norm")) \
        + params["final_norm"].numel()
    if n_params != c.total_params() + n_norms:
        fail(f"{n_params} parameters, CONFIG.total_params() "
             f"{c.total_params()} + {n_norms} norm scales expected")
    out = {"arch": LM_ARCH, "n_layers": c.n_layers, "d_model": c.d_model,
           "params": n_params, "total_params": c.total_params(),
           "init_s": init_s,
           "init_peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "reduced": [f"prefill_32k (32 x 32768 tokens) cut to "
                       f"{LM_PREFILL[0]} x {LM_PREFILL[1]} for the time "
                       f"limit; weights random from seed 0"]}
    log(f"[lm] {LM_ARCH}: {c.n_layers} layers, d_model {c.d_model}, "
        f"{c.n_heads} heads / {c.n_kv_heads} KV heads (kv_eff {c.kv_eff}), "
        f"head dim {c.hd}, vocab {c.vocab_size}; {n_params} parameters "
        f"(CONFIG.total_params() {c.total_params()} + {n_norms} norm "
        f"scales); init {init_s:.1f} s, peak {out['init_peak_gib']:.2f} GiB")
    log(f"[lm] reduced: {out['reduced']}")

    # prefill, the flash kernel's inputs captured at every layer
    kern = rt.fa_kernel.flash_attention_fwd_kernel
    entry = rt.fa_ops.flash_attention
    captured = []

    def capture(q, k, v, **kw):
        captured.append((q, k, v, kw))
        return entry(q, k, v, **kw)

    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, c.vocab_size, LM_PREFILL)).to(dev)
    rt.fa_ops.flash_attention = capture
    times, logits = [], None
    try:
        for _ in range(2):
            captured.clear()
            kern.launches = kern.wgmma_launches = 0
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits = model.prefill_fn(params, {"tokens": toks})
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            launches = flash_launches(kern)
            if launches != {WGMMA: c.n_layers, F32_FLASH: 0}:
                fail(f"prefill launched the flash kernels {launches}, want "
                     f"{c.n_layers} wgmma and 0 float32 launches")
    finally:
        rt.fa_ops.flash_attention = entry
    if len(captured) != c.n_layers:
        fail(f"{len(captured)} attention calls in a prefill")
    layers = (captured[0], captured[-1])
    if tuple(logits.shape) != (*LM_PREFILL, c.vocab_size) or \
            not torch.isfinite(logits).all():
        fail(f"prefill logits {tuple(logits.shape)} not finite or misshaped")
    n_tok = LM_PREFILL[0] * LM_PREFILL[1]
    out.update({"prefill_shape": list(LM_PREFILL), "prefill_s": times,
                "prefill_tokens_per_s": n_tok / times[-1],
                "prefill_launches": launches,
                "prefill_peak_gib": torch.cuda.max_memory_allocated() / 2**30})
    log(f"[lm] prefill {LM_PREFILL}: {times[0]:.3f} s first call, "
        f"{times[1]:.3f} s second ({n_tok / times[1]:.0f} tokens/s); "
        f"flash kernel launches per call {launches}; logits "
        f"{tuple(logits.shape)} finite; peak "
        f"{out['prefill_peak_gib']:.2f} GiB")
    del logits

    # the float32 attention path: the prefill's layers in float32 through
    # the port's attention entry point
    kern.launches = kern.wgmma_launches = 0
    for q, k, v, kw in captured:
        entry(q.float(), k.float(), v.float(), **kw)
    torch.cuda.synchronize()
    f32_launches = flash_launches(kern)
    if f32_launches != {WGMMA: 0, F32_FLASH: c.n_layers}:
        fail(f"the float32 attention path launched the flash kernels "
             f"{f32_launches}, want {c.n_layers} float32 and 0 wgmma launches")
    log(f"[lm] float32 attention path: the prefill's {c.n_layers} layers' "
        f"q/k/v in float32 through flash_attention: launches "
        f"{f32_launches}")
    del captured[1:-1]

    # the kernel against its plain version: inside the model (bf16 as the
    # model gives them, and cast to float32), then at the JAX tests'
    # shapes plus ragged lengths
    errs = {torch.bfloat16: 0.0, torch.float32: 0.0}
    for name, (q, k, v, kw) in zip(("layer 0", f"layer {c.n_layers - 1}"),
                                   layers):
        for dt in (torch.bfloat16, torch.float32):
            e = check_attention(rt, torch, q.to(dt), k.to(dt), v.to(dt),
                                kw.get("causal", True),
                                f"{name} of the prefill {tuple(q.shape)} {dt}")
            errs[dt] = max(errs[dt], e)
            log(f"[lm] {rt.fa_kernel.KERNEL_OF[dt]} on {name}'s q/k/v "
                f"{tuple(q.shape)} {str(dt)[6:]}: max |kernel - "
                f"attention_ref| {e:.3g}")
    gen = np.random.default_rng(1)
    shapes = [(2, 4, 2, 64, 64, 16, True), (1, 8, 8, 128, 128, 32, True),
              (2, 4, 1, 64, 128, 16, False), (1, 2, 2, 256, 256, 64, True),
              (1, 4, 2, 100, 1000, 128, True),
              (1, 4, 2, 1000, 100, 128, False)]
    for b, hq, hk, sq, sk, d, causal in shapes:
        arrs = [torch.from_numpy(gen.standard_normal(sh).astype(np.float32))
                .to(dev) for sh in ((b, hq, sq, d), (b, hk, sk, d),
                                    (b, hk, sk, d))]
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = (a.to(dt) for a in arrs)
            e = check_attention(rt, torch, q, k, v, causal,
                                f"{(b, hq, hk, sq, sk, d, causal)} {dt}")
            errs[dt] = max(errs[dt], e)
            log(f"[lm] {rt.fa_kernel.KERNEL_OF[dt]} "
                f"{(b, hq, hk, sq, sk, d)} causal={causal} {str(dt)[6:]}: "
                f"max error {e:.3g}")

    out["serve"] = serve_check(torch, rt, c, model, params, dev)
    if args.profile:
        out["profile"] = lm_profile(torch, c, model, params, toks, dev)

    # time and bound the kernels: at the prefill shape the wgmma kernel
    # (bf16) and the float32 kernel (the same inputs in float32) in turns,
    # then the wgmma kernel at one prefill_32k sequence
    bf16, f32 = torch.bfloat16, torch.float32
    rows = {bf16: [], f32: []}
    for (b, s) in (LM_PREFILL, LM_LONG):
        prefill = (b, s) == LM_PREFILL
        qkv = [torch.randn(b, h, s, c.hd, device=dev, dtype=bf16)
               for h in (c.n_heads, c.kv_eff, c.kv_eff)]
        reps = args.reps if prefill else max(3, args.reps // 4)
        inputs = {bf16: qkv, f32: [x.float() for x in qkv] if prefill
                  else None}
        times = {bf16: [], f32: []}
        for dt in (bf16, f32, f32, bf16) if prefill else (bf16,):
            q, k, v = inputs[dt]
            times[dt].append(device_ms(lambda: kern(q, k, v, causal=True),
                                       reps, torch))
        for dt in (bf16, f32) if prefill else (bf16,):
            rows[dt].append(time_attention(rt, torch, *inputs[dt],
                                           times[dt], reps, prefill))
    kernels = []
    for dt, path_launches in ((bf16, launches), (f32, f32_launches)):
        name, main = rt.fa_kernel.KERNEL_OF[dt], rows[dt][0]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:85",
            "dtype": str(dt)[6:], "launches": path_launches[name],
            "max_abs_err": errs[dt],
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "per_shape": rows[dt]})
    out["kernel_times"] = {str(dt)[6:]: r for dt, r in rows.items()}
    return out, kernels, params


def _leaf_grads(torch, rt, model, params, batch):
    """(loss, every gradient leaf) of ``model.loss_fn`` on ``batch``,
    the parameters made leaves that require grad."""
    leaves = rt.tree.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
        p.grad = None
    loss, _ = model.loss_fn(params, batch)
    loss.backward()
    grads = [p.grad for p in leaves]
    for p in leaves:
        p.grad = None
    return loss.detach(), grads


def train_grad_check(torch, rt, c, params, batch):
    """At full width and TRAIN_GRAD_LAYERS layers, on one microbatch: the
    kernel path's loss and every gradient leaf against the same step with
    attention's plain mirror (``_flash_attention_chunked``) on the card,
    loss within TRAIN_LOSS_REL of it and each leaf within TRAIN_GRAD_REL of
    its largest magnitude (``tests/test_torch_cuda.py``'s tolerances)."""
    c2 = c.replace(n_layers=TRAIN_GRAD_LAYERS)
    model = rt.model_api.build(c2)
    p2 = rt.tree.tree_map(lambda t: t.detach().clone(), {
        "embed": params["embed"], "final_norm": params["final_norm"],
        "layers": {k: v[:TRAIN_GRAD_LAYERS] for k, v in
                   params["layers"].items()}})
    mb = {k: v[:LM_PREFILL[0]] for k, v in batch.items()}
    kern = rt.fa_kernel.flash_attention_fwd_kernel
    kern.launches = kern.wgmma_launches = 0
    k_loss, k_grads = _leaf_grads(torch, rt, model, p2, mb)
    launches = flash_launches(kern)
    if launches != {WGMMA: 2 * TRAIN_GRAD_LAYERS, F32_FLASH: 0}:
        fail(f"the gradient check's kernel path launched {launches}")
    entry = rt.attention.flash_attention
    rt.attention.flash_attention = \
        lambda q, k, v, causal=True, chunk=1024: \
        rt.attention._flash_attention_chunked(q, k, v, causal, chunk)
    try:
        p_loss, p_grads = _leaf_grads(torch, rt, model, p2, mb)
    finally:
        rt.attention.flash_attention = entry
    if flash_launches(kern) != launches:
        fail("the plain mirror's gradient check launched a flash kernel")
    keys = list(rt.tree.flatten_dict(p2))
    worst = {}
    for key, a, b in zip(keys, p_grads, k_grads):
        if not torch.isfinite(b).all():
            fail(f"[train] gradient {key} of the kernel path is not finite")
        rel = float((a - b).abs().max() / a.abs().max())
        worst[key] = rel
        if rel > TRAIN_GRAD_REL:
            fail(f"[train] gradient {key}: kernel path differs from the "
                 f"plain mirror's by {rel:.4g} of its largest magnitude "
                 f"(tolerance {TRAIN_GRAD_REL})")
    loss_rel = abs(float(k_loss) - float(p_loss)) / abs(float(p_loss))
    if loss_rel > TRAIN_LOSS_REL:
        fail(f"[train] loss {float(k_loss)} of the kernel path against "
             f"{float(p_loss)} of the plain mirror (tolerance "
             f"{TRAIN_LOSS_REL} relative)")
    log(f"[train] gradient check, {TRAIN_GRAD_LAYERS} layers at full width, "
        f"one microbatch {tuple(mb['tokens'].shape)}: loss {float(k_loss):.6f} "
        f"(kernel) vs {float(p_loss):.6f} (plain mirror), relative "
        f"{loss_rel:.3g}; worst gradient leaf {max(worst, key=worst.get)} "
        f"at {max(worst.values()):.4g} of its largest magnitude (tolerance "
        f"{TRAIN_GRAD_REL}); flash launches {launches}")
    return {"layers": TRAIN_GRAD_LAYERS, "kernel_loss": float(k_loss),
            "plain_loss": float(p_loss), "loss_rel": loss_rel,
            "grad_rel": worst}


def train_resume_check(torch, rt, dev):
    """At the REDUCED config on the card: 4 steps with a checkpoint at 4,
    then a resumed run to 6; two uninterrupted runs of 6.  The three final
    losses and parameter trees must be equal bit for bit."""
    c = rt.configs.get(LM_ARCH, reduced=True)
    cell = rt.ShapeCell("train_resume", "train", *TRAIN_RESUME_SHAPE)
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        rt.train_launcher.train(c, cell, steps=TRAIN_RESUME_AT,
                                ckpt_dir=f"{tmp}/a", ckpt_every=TRAIN_RESUME_AT,
                                log_every=0, device=dev)
        if rt.checkpoint.latest_step(f"{tmp}/a") != TRAIN_RESUME_AT:
            fail("[train] the interrupted run committed no checkpoint")
        for name, ckpt_dir in (("resumed", f"{tmp}/a"),
                               ("uninterrupted", None),
                               ("uninterrupted again", None)):
            params, _, hist = rt.train_launcher.train(
                c, cell, steps=TRAIN_RESUME_STEPS, ckpt_dir=ckpt_dir,
                log_every=0, device=dev)
            runs[name] = (hist, rt.tree.tree_leaves(params))
    hist_r, leaves_r = runs["resumed"]
    if len(hist_r) != TRAIN_RESUME_STEPS - TRAIN_RESUME_AT:
        fail(f"[train] the resumed run ran {len(hist_r)} steps")
    losses = {k: h[-1]["loss"] for k, (h, _) in runs.items()}
    for name, (hist, leaves) in runs.items():
        same = all(torch.equal(a, b) for a, b in zip(leaves, leaves_r))
        if hist[-1]["loss"] != hist_r[-1]["loss"] or not same:
            fail(f"[train] the {name} run ends at loss {hist[-1]['loss']!r}"
                 f" (parameters equal: {same}), the resumed run at "
                 f"{hist_r[-1]['loss']!r}")
    log(f"[train] resume at {c.name} {TRAIN_RESUME_SHAPE}: {TRAIN_RESUME_AT} "
        f"steps + checkpoint, resumed to {TRAIN_RESUME_STEPS}; final losses "
        f"{losses} equal bit for bit, and every parameter")
    return {"config": c.name, "final_losses": losses}


def phase_train(args, torch, rt, params):
    """Train steps of the full-size model on phase 5's f32 master weights,
    the flash kernel's launches counted a step, then the gradient and
    resume checks."""
    import numpy as np

    dev = torch.device("cuda")
    c = rt.configs.get(LM_ARCH)
    model = rt.model_api.build(c)
    cell = rt.ShapeCell(*TRAIN_CELL)
    accum = c.grad_accum
    opt_cfg = rt.optim.OptimConfig(name=c.optimizer)
    step_fn = rt.train_step.make_train_step(model, opt_cfg, cell)[0]
    out = {"cell": list(TRAIN_CELL), "grad_accum": accum, "remat": c.remat,
           "optimizer": c.optimizer,
           "reduced": [f"train_4k's global batch 256 cut to "
                       f"{TRAIN_CELL[3]} (grad_accum {accum}, microbatch "
                       f"{TRAIN_CELL[3] // accum}) to fit one card's 80 GB"
                       f"; weights random from seed 0"]}
    log(f"[train] {LM_ARCH} {c.n_layers} layers, d_model {c.d_model}, "
        f"{c.optimizer}, grad_accum {accum}, remat {c.remat!r}, cell "
        f"{TRAIN_CELL}; reduced: {out['reduced']}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # what the card holds already: the weights and earlier phases' tensors
    base = torch.cuda.memory_allocated()
    weights = rt.tree.param_bytes(params)
    opt_state = rt.optim.init_opt(c.optimizer, params, opt_cfg)
    want = {WGMMA: 2 * c.n_layers * accum, F32_FLASH: 0}
    kern = rt.fa_kernel.flash_attention_fwd_kernel
    fn_cls = rt.attention.FlashAttentionFn
    backward = fn_cls.backward
    bwd_events = []

    def timed_backward(ctx, grad_out):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        grads = backward(ctx, grad_out)
        b.record()
        bwd_events.append((a, b))
        return grads

    steps = []
    n_tok = TRAIN_CELL[2] * TRAIN_CELL[3]
    flops = model.model_flops(cell)
    fn_cls.backward = staticmethod(timed_backward)
    try:
        for step in range(TRAIN_STEPS):
            batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                     for k, v in rt.train_data.make_batch(c, cell,
                                                          step).items()}
            bwd_events.clear()
            kern.launches = kern.wgmma_launches = 0
            torch.cuda.synchronize()
            t = time.perf_counter()
            params, opt_state, met = step_fn(params, opt_state, batch)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
            launches = flash_launches(kern)
            if launches != want:
                fail(f"[train] step {step} launched the flash kernels "
                     f"{launches}, want {want} (forward and the remat "
                     f"recompute of {c.n_layers} layers x {accum} "
                     f"microbatches)")
            loss, gnorm = float(met["loss"]), float(met["grad_norm"])
            if not (math.isfinite(loss) and math.isfinite(gnorm)):
                fail(f"[train] step {step}: loss {loss}, grad norm {gnorm}")
            if len(bwd_events) != c.n_layers * accum:
                fail(f"[train] step {step}: {len(bwd_events)} attention "
                     f"backward calls")
            bwd_ms = sum(a.elapsed_time(b) for a, b in bwd_events)
            steps.append({
                "step": step, "loss": loss, "grad_norm": gnorm,
                "lr": float(met["lr"]), "s": dt, "tokens_per_s": n_tok / dt,
                "mfu": flops / dt / BF16_TFLOPS, "launches": launches,
                "attn_bwd_ms": bwd_ms, "attn_bwd_share": bwd_ms / (dt * 1e3)})
            log(f"[train] step {step}: loss {loss:.6f}"
                + (f" (ln V = {math.log(c.vocab_size):.6f})" if step == 0
                   else "") + f", grad norm {gnorm:.4f}, lr "
                f"{float(met['lr']):.4g}; {dt:.3f} s, {n_tok / dt:.0f} "
                f"tokens/s, model FLOPs {flops:.4g} = "
                f"{flops / dt / BF16_TFLOPS:.1%} of 989 TFLOP/s; attention's "
                f"plain backward {bwd_ms:.1f} ms of device time in "
                f"{len(bwd_events)} calls ({bwd_ms / (dt * 1e3):.1%} of the "
                f"step); flash launches {launches}")
    finally:
        fn_cls.backward = staticmethod(backward)
    out["steps"] = steps
    peak = torch.cuda.max_memory_allocated()
    out.update(peak_gib=peak / 2**30, base_gib=base / 2**30,
               train_peak_gib=(peak - base + weights) / 2**30)
    log(f"[train] peak memory over the {TRAIN_STEPS} steps "
        f"{out['peak_gib']:.2f} GiB, {out['base_gib']:.2f} GiB of it "
        f"allocated before them (weights {weights / 2**30:.2f} GiB and "
        f"earlier phases' tensors): training needs "
        f"{out['train_peak_gib']:.2f} GiB (weights, AdamW moments, "
        f"gradients, activations)")
    del opt_state
    torch.cuda.empty_cache()
    out["grad_check"] = train_grad_check(torch, rt, c, params, batch)
    out["resume"] = train_resume_check(torch, rt, dev)
    launches = {WGMMA: sum(s["launches"][WGMMA] for s in steps),
                F32_FLASH: sum(s["launches"][F32_FLASH] for s in steps)}
    return out, launches


def flash_launches(kern) -> dict:
    """Launches of each flash kernel since the counters were set to 0."""
    return {WGMMA: kern.wgmma_launches,
            F32_FLASH: kern.launches - kern.wgmma_launches}


def time_attention(rt, torch, q, k, v, k_times, reps, plain: bool) -> dict:
    """One flash kernel's timing row: its device times (``k_times``, taken
    in turns with the other kernel's), the plain version (if ``plain``) and
    SDPA on the same inputs, and the bound."""
    b, hq, s, d = q.shape
    k_ms = sum(k_times) / len(k_times)
    if plain:
        p_ms = loop_ms(lambda: rt.fa_ref.attention_ref(q, k, v, causal=True),
                       reps, torch)
    else:
        p_ms = None
        log(f"[lm] plain attention_ref not timed at {(b, s)}: its float32 "
            f"scores alone would take {b * hq * s * s * 4 / 2**30:.0f} GiB")
    sdpa = rt.torch.nn.functional.scaled_dot_product_attention
    gqa = k.shape[1] != q.shape[1]
    lib_ms = loop_ms(lambda: sdpa(q, k, v, is_causal=True, enable_gqa=gqa),
                     reps, torch)
    b_ms, kind = attention_bound(q, k)
    cuda_cores = ("" if q.element_size() == 2 else
                  f"; the same flops at the CUDA cores' float32 rate "
                  f"{attention_flops(q, k) / F32_OPS_PER_S * 1e3:.4f} ms")
    log(f"[lm] {rt.fa_kernel.KERNEL_OF[q.dtype]} {(b, hq, s, d)} {str(q.dtype)[6:]} causal: kernel "
        + " / ".join(f"{t:.4f}" for t in k_times) + f" ms (mean {k_ms:.4f}),"
        f" plain {'not timed' if p_ms is None else f'{p_ms:.3f} ms'}, SDPA "
        f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({kind}); kernel at "
        f"{b_ms / k_ms:.1%} of its bound{cuda_cores}")
    return {"shape": [b, hq, s, d], "ms": k_ms, "ms_each": k_times,
            "plain_ms": p_ms, "library_ms": lib_ms, "bound_ms": b_ms,
            "bound_by": kind}


def lm_profile(torch, c, model, params, toks, dev):
    """One prefill call and four batched decode steps (the serving
    engine's slots, a cache filled to 64 positions), traced."""
    out = [traced(torch, f"prefill_fn {tuple(toks.shape)}",
                  lambda: model.prefill_fn(params, {"tokens": toks}))]
    slots = LM_SERVE["batch_slots"]
    state = model.init_decode_state(params, slots, LM_SERVE["max_seq"])
    state = state._replace(cache=state.cache._replace(
        pos=torch.full((slots,), 64, dtype=torch.int32, device=dev)))
    tok = toks[0, :slots]

    def steps():
        st = state
        for _ in range(4):
            _, st = model.decode_fn(params, tok, st)

    out.append(traced(torch, f"4 decode steps of {slots} slots", steps))
    return out


def serve_check(torch, rt, c, model, params, dev):
    """``ServeEngine`` answers the requests; each prompt's decode logits
    (after its last token) against ``prefill_fn``'s last position."""
    import numpy as np

    gen = np.random.default_rng(2)
    lo, hi = LM_SERVE["prompt"]
    prompts = [gen.integers(0, c.vocab_size, int(n)).tolist()
               for n in gen.integers(lo, hi + 1, LM_SERVE["requests"])]
    eng = rt.ServeEngine(c, params, batch_slots=LM_SERVE["batch_slots"],
                         max_seq=LM_SERVE["max_seq"], device=dev)
    decode_logits = {}
    prefill_into = eng._prefill_into

    def capture(state, slot, prompt):
        state, logits = prefill_into(state, slot, prompt)
        decode_logits[tuple(prompt)] = logits[0]
        return state, logits

    eng._prefill_into = capture
    reqs = [rt.Request(prompt=p, max_new=LM_SERVE["max_new"]) for p in prompts]
    torch.cuda.synchronize()
    t = time.perf_counter()
    done = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    if len(done) != len(prompts) or any(
            len(r.output) != LM_SERVE["max_new"] for r in done):
        fail(f"ServeEngine answered {len(done)} of {len(prompts)} requests "
             f"or cut one short")
    n_new = sum(len(r.output) for r in done)
    n_prompt = sum(len(p) for p in prompts)
    worst, agree = 0.0, 0
    for p in prompts:
        ref = model.prefill_fn(params, {"tokens": torch.tensor(
            [p], device=dev)})[0, -1].float()
        got = decode_logits[tuple(p)].float()
        rel = float((got - ref).abs().max() / ref.abs().max())
        worst = max(worst, rel)
        agree += int(torch.argmax(got) == torch.argmax(ref))
        if not torch.isfinite(got).all() or rel > LM_LOGIT_REL:
            fail(f"decode logits after a {len(p)}-token prompt differ from "
                 f"prefill_fn's by {rel:.4f} of the row's largest |logit| "
                 f"(tolerance {LM_LOGIT_REL})")
    lat = sorted(r.latency_s for r in done)
    out = {"requests": len(done), "prompt_tokens": n_prompt,
           "new_tokens": n_new, "wall_s": wall,
           "new_tokens_per_s": n_new / wall,
           "tokens_per_s": (n_new + n_prompt) / wall,
           "latency_s": lat, "decode_vs_prefill_rel": worst,
           "argmax_agree": agree, **LM_SERVE}
    log(f"[lm] serve: {len(done)} requests ({n_prompt} prompt tokens, "
        f"{n_new} new) in {wall:.2f} s: {n_new / wall:.1f} new tokens/s, "
        f"{(n_new + n_prompt) / wall:.1f} tokens/s with the prompts' decode "
        f"steps; latency per request {[round(x, 3) for x in lat]} s; decode "
        f"logits after each prompt within {worst:.4f} of prefill_fn's row "
        f"scale (tolerance {LM_LOGIT_REL}), argmax equal on {agree} of "
        f"{len(prompts)}")
    return out


def clocks(stage: str) -> None:
    """The card's SM clock, its maximum, temperature and power draw."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,temperature.gpu,"
         "power.draw", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    log(f"[clocks] {stage}: " + (smi.stdout.strip() if smi.returncode == 0
                                else f"nvidia-smi failed: {smi.stderr}"))


def traced(torch, what: str, fn, top: int = 15):
    """``fn()`` under ``torch.profiler``: device time by kernel name
    (largest first) and the device's busy share of the traced wall time.
    The profiler adds host overhead, so the traced wall time is not the
    untraced run's."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3

    by_name: dict = {}
    for e in device_events(prof):
        us, calls = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), calls + 1)
    busy_ms = sum(us for us, _ in by_name.values()) / 1e3
    rows = [{"op": k, "device_ms": us / 1e3, "calls": calls}
            for k, (us, calls) in sorted(by_name.items(),
                                         key=lambda kv: -kv[1][0])[:top]]
    log(f"[profile] {what} under the profiler: wall {wall_ms:.1f} ms, "
        f"device busy {busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%)")
    for r in rows:
        log(f"[profile]   {r['device_ms']:10.2f} ms  {r['calls']:7d}x  "
            f"{r['op'][:90]}")
    return {"what": what, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "top_ops": rows}


def phase_profile(torch, rt, name, g):
    """One ``louvain(backend="pallas")`` run of ``g``, traced."""
    return dict(traced(torch, f"{name} louvain(pallas)",
                       lambda: rt.louvain(g, rt.LouvainConfig(
                           backend="pallas"))), graph=name)


def runtime(torch):
    """The port's modules the phases use, as one namespace; fails when the
    package is not next to this script."""
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch.graph.datasets as datasets
        from repro_torch.core.engine import SweepEngine
        from repro_torch.core.louvain import (LEVEL_IT_STRIDE, LouvainConfig,
                                              leiden, louvain)
        from repro_torch.core.plp import PLPConfig, plp
        from repro_torch.graph.ell import (build_ell, compute_windows,
                                           tile_contract)
        from repro_torch.core import moves
        from repro_torch.kernels import build
        from repro_torch.kernels.aggregation import kernel as agg_kernel
        from repro_torch.kernels.aggregation import ops as agg_ops
        from repro_torch.kernels.aggregation import ref as agg_ref
        from repro_torch.kernels.delta_q import kernel as dq_kernel
        from repro_torch.kernels.delta_q import ops as dq_ops
        from repro_torch.kernels.delta_q import ref as dq_ref
        from repro_torch.kernels.label_argmax import kernel as la_kernel
        from repro_torch.kernels.label_argmax import ops as la_ops
        from repro_torch.kernels.label_argmax import ref as la_ref
        from repro_torch.kernels.local_move import kernel as lm_kernel
        from repro_torch.kernels.local_move import ops as lm_ops
        from repro_torch.kernels.local_move import ref as lm_ref
        from repro_torch.kernels.segment_sum import kernel as ss_kernel
        from repro_torch.kernels.segment_sum import ops as ss_ops
        from repro_torch.kernels.segment_sum import ref as ss_ref
        from repro_torch.utils import faultinject, telemetry
        from repro_torch.utils.resilience import Preempted
        from repro_torch import configs
        from repro_torch.kernels.flash_attention import kernel as fa_kernel
        from repro_torch.kernels.flash_attention import ops as fa_ops
        from repro_torch.kernels.flash_attention import ref as fa_ref
        from repro_torch.launch.serve import Request, ServeEngine
        from repro_torch.core.batch import louvain_batch, plp_batch
        from repro_torch.core.expert_placement import (
            coactivation_graph, louvain_placement, placement_traffic,
            random_placement)
        from repro_torch.graph.builders import from_numpy_edges
        from repro_torch.graph.generators import sbm
        from repro_torch.kernels.common import capacity_signature
        from repro_torch.launch.community_serve import (
            CommunityServeEngine, smoke_requests)
        from repro_torch.launch.ranks import init_group, spawn_ranks
        from repro_torch.models import api as model_api
        from repro_torch.models import attention
        from repro_torch.models.arch_config import ShapeCell
        from repro_torch.models.common import init_params, param_count
        from repro_torch.launch import train as train_launcher
        from repro_torch.launch import train_step
        from repro_torch.train import checkpoint, optim
        from repro_torch.train import data as train_data
        from repro_torch.utils import tree
    except ImportError as err:
        fail(f"the repro_torch package is not next to this script ({err})")
    return argparse.Namespace(
        datasets=datasets, LouvainConfig=LouvainConfig, louvain=louvain,
        leiden=leiden, faultinject=faultinject, Preempted=Preempted,
        SweepEngine=SweepEngine, LEVEL_IT_STRIDE=LEVEL_IT_STRIDE,
        PLPConfig=PLPConfig, plp=plp, build_ell=build_ell,
        compute_windows=compute_windows, tile_contract=tile_contract,
        agg_kernel=agg_kernel, agg_ops=agg_ops, agg_ref=agg_ref,
        lm_kernel=lm_kernel, lm_ops=lm_ops, lm_ref=lm_ref, moves=moves,
        la_kernel=la_kernel, la_ops=la_ops, la_ref=la_ref,
        dq_kernel=dq_kernel, dq_ops=dq_ops, dq_ref=dq_ref,
        ss_kernel=ss_kernel, ss_ops=ss_ops, ss_ref=ss_ref, torch=torch,
        telemetry=telemetry, configs=configs, fa_kernel=fa_kernel,
        fa_ops=fa_ops, fa_ref=fa_ref, Request=Request,
        ServeEngine=ServeEngine, model_api=model_api,
        init_params=init_params, param_count=param_count,
        louvain_batch=louvain_batch,
        plp_batch=plp_batch, coactivation_graph=coactivation_graph,
        louvain_placement=louvain_placement,
        placement_traffic=placement_traffic,
        random_placement=random_placement,
        from_numpy_edges=from_numpy_edges, sbm=sbm,
        capacity_signature=capacity_signature,
        CommunityServeEngine=CommunityServeEngine,
        smoke_requests=smoke_requests, init_group=init_group,
        spawn_ranks=spawn_ranks, attention=attention, ShapeCell=ShapeCell,
        train_launcher=train_launcher, train_step=train_step,
        checkpoint=checkpoint, optim=optim, train_data=train_data, tree=tree,
        build=build)


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--profile", action="store_true",
                   help="also trace one Louvain run of the first graph, one "
                        "LM prefill and four LM decode steps")
    p.add_argument("--out", default=None,
                   help="also write every measurement to this JSON file")
    args = p.parse_args(argv)

    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    rt = runtime(torch)
    t0 = time.perf_counter()
    name, count, card = phase_device(torch)
    phase_build(rt.build)
    main_out, recs, graphs, runs = phase_main(torch, rt)
    main_out["leiden"] = phase_leiden(torch, rt, graphs, runs)
    main_out["serve"] = phase_serve(torch, rt, card)
    main_out["dist"] = phase_dist(torch, rt, graphs, card)
    main_out["two_step"], captured, seg_inputs = phase_two_step(
        args, torch, rt, recs, graphs)
    clocks("before phase 4")
    kernels = phase_kernels(args, torch, rt, recs, main_out["launches"],
                            main_out["coarse_launches"])
    kernels += phase_scored_tiles(args, torch, rt, captured, seg_inputs,
                                  main_out["two_step"]["launches"])
    for row in kernels:
        if row["name"] == "bin_rank":
            # phase 3d's launches, (a) and every rank of (b)
            row["dist_launches"] = main_out["dist"]["bin_rank_launches"]
    clocks("after phase 4")
    main_out["lm"], lm_kernels, lm_params = phase_lm(args, torch, rt)
    kernels += lm_kernels
    clocks("after phase 5")
    t = time.perf_counter()
    main_out["train"], train_launches = phase_train(args, torch, rt,
                                                    lm_params)
    main_out["train"]["phase_s"] = time.perf_counter() - t
    log(f"[train] phase 5t took {main_out['train']['phase_s']:.1f} s")
    del lm_params
    for row in lm_kernels:
        row["train_launches"] = train_launches[row["name"]]
    clocks("after phase 5t")
    if args.profile:
        main_out["profile"] = phase_profile(
            torch, rt, MAIN_GRAPH[0], graphs[MAIN_GRAPH[0]][0])
    main_out["total_s"] = time.perf_counter() - t0
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": card, "device": name, "main": main_out,
             "kernels": kernels}, indent=1, default=str))
    log(f"[done] {main_out['total_s']:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
