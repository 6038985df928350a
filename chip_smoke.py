#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths once on one GPU and check them.

    python3 chip_smoke.py
    python3 chip_smoke.py --shard-phases   # the build, 9, 10, 10b, 11a only
    python3 chip_smoke.py --ckks-phases    # the build, 11b, 11c, 11d only
    python3 chip_smoke.py --fae-phases     # the build, 8b and 11d only

Phases, each printing one JSON line:

  1. build   — compile every kernel from src/repro_torch/kernels/csrc;
               each kernel's registers, stack and spills (ptxas), and the
               tensor-core (IMMA) instructions of the gadget Eval.
  2. serve   — the read path, after a warm-up on 4,096 rows: keygen
               (paper-bfv, gadget mode; its eval-domain CEK runs the
               forward NTT kernel, a*sk the two-varying multiply), the
               full hg38 column (34,423 rows, padded to 65,536)
               encrypted on the card (pk0 and pk1 transformed once, then
               the key multiply), a
               QueryServer(batch=4) answering 8 requests.
  3. kernels — each serve-path kernel against its plain PyTorch version
               on the card, byte-equal (torch.equal; residues are
               integers, so the tolerance is 0), on the served column at
               every tile shape the served batches gave the Eval kernel,
               plus edge shapes and a tile of the largest digits; the
               multiply against each key's transform at every row count
               the paths give it; kernel and plain times by CUDA events;
               bounds from the bytes, the card's integer multiply-add
               rate and (the gadget Eval) its dense INT8 tensor-core
               rate.
  4. profile — the same requests traced and under torch.profiler:
               engine counters, span totals, device busy share, device
               time by kernel name.
  5. index   — SortedIndex.build over 4,096 rows (encrypted_sort through
               the Eval kernel), point lookups and ranges vs the truth.
  6. keymul  — gadget_keymul on 1,024 served lanes: ring.ntt/intt on the
               card run the ntt_br kernels (forward and inverse); coeff 0
               of scale·d0 + keymul must equal the gadget Eval kernel's
               residues (two independent kernels).  Then ntt_br in both
               directions against its plain version at keygen's
               [8, 2, 4096], at [1, 2, 16384], [4, 2, 16384] and
               [8, 2, 16384] (paper-ckks key_br and keygen), at the keymul
               shapes [8192, 2, 4096] and [1024, 2, 4096], at [33, 2,
               4096] and at the row counts on each side of every change
               of the card's plan (kernels/ntt.py) at both degrees, and
               the round trip; each shape timed in its planned form
               (cluster or wide) and as the C = 1 kernel of
               tools/ntt_c1.cu (built beside the package's), in turns,
               beside its bound and the empty-launch floor.
  7. write   — the paper-mode write path (paper_ecek_weight=0), after
               the gadget table is freed: keygen, the hg38 column
               encrypted, SortedIndex.build over all 34,423 rows, then
               the write benchmark's traffic (5 % = 1,721 inserts in 4
               chunks, each followed by a Range; a delete of 2 rows and a
               full-range query; the 8 requests of phase 2 scanned over
               base ∪ delta; a union Eq probe of a delta value; compact;
               the probe again), every answer held against the running
               plaintext, under obs tracing (span totals) and with the
               compaction under torch.profiler.
  8. paper   — the paper Eval kernel against its plain version at every
               shape the write phase gave it (column pass at its scan
               tiles, 2,048-row delta tiles and the full 65,536 rows,
               bounds pass, lane form at 32,768 sort pairs, 65,536 merge
               pairs and the probe lanes, one bound for every lane), and
               at every shape the write path recorded, its calls
               reconciled with the path's launches; each recorded shape
               split into the kernel's device time (CUDA graph replay),
               the wrapper's host time and the empty launch's floor
               (kernels/timing.py).  Then its edges: 1, 3, 5 and 127
               lanes (multiples of no cluster size), one b for every
               lane, the column form at a row offset, and n = 16,384
               (paper mode on the paper-ckks ring), split and wide.
  8b. fae (a) — after the write table is freed, a FAE table (Alg. 3)
               over full hg38 on the serve phase's keys: v (positions)
               and the tie-heavy w = v // 64, every row's Alg. 3
               operands drawn by the script (`Table.from_arrays(
               samples=)`); SortedIndex on each, Ranges on v and Eq on w
               (linear and indexed), And/Or, TopK 8 and OrderBy on w, a
               QueryServer batch of 8, 1,721 EncBasic inserts and a
               delete, reads over base ∪ delta, compaction into both
               indexes, the reads again, then the sort-merge Eq join of
               w against an EncBasic table of its distinct values, and
               Finding F2 over 4,096 pairs (Alg. 4 flip share within
               6σ of 1/2, the τ-decode's tie rate, the EncBasic
               control's).  Each answer equal to the plaintext's (F2)
               and to the drawn and decrypted perturbed readings
               (`_FaeTruth`); order stages' values in the plaintext's
               order; every kernel shape against plain, launches
               reconciled.
  9. shard   — after the FAE table is freed, the serve keys' hg38 table
               re-encrypted (same seed, same rows) and re-partitioned into
               4 logical shards ([4, 16,384] slots), unplaced; a
               ShardedQueryServer(batch=4) answers the 8 requests and the
               sharded benchmark's query (30th-70th percentile Range,
               TopK 8), each equal to the unsharded server's answer and
               the truth; the scan ratio against S = 1 and the merge
               bound; a ShardedIndex Eq probe; a 431-row sharded insert,
               a Range over base ∪ delta, compaction, the Range again.
               Then one shard-stacked scan tile against its plain version,
               and the gadget Eval against its plain version at every
               shape the path gave it, on rows of the sharded column.
 10. join    — the join benchmark's traffic (hg38 keys mod 4,302):
               sort-merge at full hg38 through QueryServer.submit_join
               (left 34,423 rows, right the last 17,211; both SortedIndex
               builds timed), then nested loops on a cut (the first 8,192
               x 4,096 rows) in gadget mode (two joins deduped onto one
               grid, and a [4 x 4]-shard join) and in paper mode (the
               write keys); the sort-merge join again with both sides
               in 4 shards (their ShardedIndexes built by the join),
               its pairs equal to the unsharded join's.  Then the
               gadget Eval against its plain
               version at every shape the path gave it, the paper Eval
               likewise (its calls reconciled), and the pair-grid
               Eval layouts (gadget: the negated right column against
               negated left atoms, with a q - 1 digit tile; paper: the
               column form of both sides) against their plain versions.
 10b. placement — the shard phase's traffic (it runs unplaced, every
               shard on the card) on placed tables, on two shard meshes:
               (a) `ShardSpec.create(4)`, the visible cards (d = 1 on a
               machine with one card, which the record says), and (b)
               four explicit positions over the cards (`[cuda:0] * 4` on
               one card: d = 4, four slabs, each slab's Eval launches
               on its position's card).  Each mesh: the hg38 table
               re-encrypted (same seed, same rows) and placed, the 8
               requests and the Range/TopK-8, the ShardedIndex Eq probe,
               431 inserts with a Range, the union scan, compaction, the
               Range again, the [4 x 4] nested and sort-merge joins on
               the join phase's cut, and one paper-mode scan under the
               write keys.  Every
               raw fused-scan and pair-grid value byte-equal to the
               unplaced runs' (sha256 of each call's array), every answer
               equal to theirs and to the plaintext; the gadget and paper
               Eval against their plain versions at every shape the
               placed path gave them, launches reconciled; walls and each
               card's peak memory.
 11. loop    — after the earlier tables are freed, the serving-loop
               benchmark's traffic (benchmarks/serve_loop.py::run at
               rows = 65,536): two tenants with their own paper-mode
               keys and ACLed indexed tables of 57,344 rows, alice's hot
               write table, one ServeLoop; warm-up, isolated points, the
               steady mix (points with deadlines, bulk ranges, a nested
               join, inserts with union probes), a poisoned plan in a
               shared drain, a round in the always-on mode with two
               client threads, the overload.  Every answer against the
               plaintext; point p99 mixed ≤ 2 × isolated, shed 0, no new
               launch signature in the steady mix, explicit REJECTED and
               SHED.  Then the paper Eval and both multiplies against
               their plain versions at every shape the loop launched
               them at, on rows of each tenant's own column, launch
               counts reconciled; each paper shape split into device,
               host and floor times beside its bound.
 11a. loop_shard — after phase 11's tables are freed, the serving loop in
               front of a sharded table: alice's tenant (57,344 live
               rows, seed 11, phase 11's paper keys) with an unindexed
               column w beside v, as a plain QueryServer and in 4 shards
               of 16,384 slots with a ShardedIndex on v, behind one
               ServeLoop(batch=8), in three layouts: (a) unplaced, the
               plain tenant registered beside it; (b) placed on
               [cuda:0] * 4; (c) cuda:0-3 when four cards are visible,
               else recorded as skipped.  Each: warm-up, 64 isolated
               point Eqs (classified point), the steady mix (points with
               deadlines, bulk Ranges on w, a TopK 8), a join (REJECTED
               at admission, counters unchanged), a write wave (4 insert
               chunks, compaction at the threshold while queries wait,
               a delete, an update; every read sees exactly the writes
               admitted before it), a poisoned plan, one traced round,
               the always-on round with two client threads, the
               overload.  Every answer equal to the plaintext and to the
               plain tenant's; (b)'s and (c)'s raw scan values (sha256)
               and answers equal to (a)'s; per tenant, submitted = ok +
               rejected + shed + failed; no new launch signature in the
               steady mix; after compaction no old stack allocated; the
               paper Eval, the key multiply and (four cards) ntt_br
               against their plain versions at every shape, launches
               reconciled; walls, point p50/p99 (the mixed/isolated
               ratio printed, not gated), inserts/s, the compaction's
               wall, busy share, each card's peak.
 11b. ckks   — after the loop's tables are freed, float columns through
               the engine at paper-ckks in gadget mode (n = 16,384: a row
               is 512 KiB), the traffic of benchmarks/fig2_ckks.py and
               benchmarks/db_engine.py::run_ckks on values put on a 0.25
               lattice in [0, 1000]: fig2's micro-operations over 100
               values (keygen, Enc Basic/FAE, Cmp Basic/FAE, each sign
               checked); table (a), the bitcoin stand-in's 1,085 rows,
               and (b), hg38's first 16,384 rows, each with v and a
               lattice aux column; SortedIndex.build on each v; an
               ε-band Eq, 4 Ranges with off-lattice bounds (linear and
               indexed) and And(Range, ε-band Eq) + TopK 5 on both; a
               QueryServer batch of 8 ε-band Eqs and Ranges over (b)'s
               index, each with its own ε; the ε-band sort-merge join of
               (b).v against (a).v with its verify pass; then on (b) 819
               inserts, 8 deletes, ε-band Eq and Range over base ∪ delta
               (scan and indexed), compaction, the reads again.  Every
               answer against numpy on the plaintext; the gadget Eval,
               both multiplies and ntt_br against their plain versions
               at every shape the phase launched them at, launches
               reconciled; walls, queries/s, inserts/s, peak memory.
 11c. ckks_shard — the float phase's tables, queries and writes on
               ShardedTables (its keys reused, its tables freed): (a) in
               4 shards of 512 slots, (b) in 4 of 4,096 (16 GiB), run
               unplaced and then placed on four mesh positions over the
               cards ([cuda:0] * 4 on one card; cuda:0-3 on four, else
               recorded as skipped): ShardedIndex builds, the ε-band
               Eq, Ranges and And + TopK (linear and indexed), a
               ShardedQueryServer batch of 8 with its own τ a lane, the
               ε-band sort-merge join (b).v x (a).v with its verify pass
               and a nested cross-check on (b)'s first 1,024 rows, then
               (a) freed and on (b) 819 inserts routed to the shards, 8
               deletes, union reads, compaction (each shard 4,096 ->
               8,192 slots), the reads again; then (b) encrypted again
               (the same ciphertexts) behind a ServeLoop: its ε-band
               points and Ranges, the And + TopK 5 as bulk, the 819
               inserts as one chunk (compaction at the threshold with
               the deletes and two reads queued) and the reads after.
               Every answer equal to the
               plaintext and to 11b's unsharded answer; the placed run's
               raw scan, grid and verify values sha256-equal to the
               unplaced run's; every gadget Eval, multiply and ntt_br
               shape equal to plain, launches reconciled (paper Eval 0);
               walls, busy shares, each card's peak.
 11d. fae (b) — FAE tables at paper-ckks on the float phase's keys:
               bitcoin's 1,085 rows and hg38's first 16,384, v and aux
               FAE with drawn operands; the float phase's traffic (its
               bands and bounds lie 0.125 from every lattice step, so
               each answer equals the drawn perturbed reading with no
               row undecided) and then the trap: Eq at the native τ
               (2^-7, against ε = 0.01) and at one lattice step, held
               against the drawn and decrypted readings outside their
               noise bands, with the rows that differ from the
               unperturbed plaintext counted.  Kernel shapes against
               plain, launches reconciled.
 12. lm      — smollm-360m at full width in bfloat16 (seeded weights):
               8 requests in batches of 4, prompt 32, 16 greedy tokens;
               one batch's decode steps under torch.profiler (device
               busy time, kernels a step, the host's top operations);
               float32 on the card against the CPU (relative error ≤
               2e-5, and the same prefill with TF32 matmuls, the
               control, above it), decode_step against forward (≤
               2e-2), the share of bfloat16 greedy tokens equal to
               float32's.  Then an
               encrypted top-8 over one request's scores at 4,096
               candidate tokens under paper-ckks gadget keys (n =
               16,384), each pick within the CKKS tolerance of the
               plaintext; the gadget Eval and both multiplies against
               their plain versions at every shape the bridge launched
               them at, launch counts reconciled.
 13. lm_family — minicpm3-4b (MLA), deepseek-moe-16b (MoE: 64 routed
               + 2 shared experts, top-6, capacity 1.25),
               recurrentgemma-9b (RG-LRU with local attention, window
               2,048), whisper-base (the encoder over 1,500 seeded
               random frames, cross attention), xlstm-125m (mLSTM and
               sLSTM alternating, their recurrent caches) and
               llava-next-34b (60 layers, 68.8 GB of weights; prompts
               of 576 + 32 tokens, the first 576 replaced by zero
               patches), each at its published width and depth in
               bfloat16 with seeded weights and freed before the next
               (but minicpm3-4b at 31 of its 62 layers and
               deepseek-moe-16b at 14 of 28, for the script's time, and
               a family whose weights would not leave 10 GiB of the card
               free at fewer layer groups; each cut printed as
               "depth_cut"): the
               lm phase's traffic and decode trace; float32 at full
               width and one layer group's depth (recurrentgemma: 3
               layers, so local attention is in it; whisper: one encoder
               layer too; llava: 2 prompts with seeded random patches),
               card against the CPU under LM_CPU_REL_TOL with the TF32
               control above it, and decode_step against forward (≤
               2e-2; a MoE at the no-drop capacity E/k); deepseek-moe's
               expert ids card against CPU (as `moe.route` returned them
               in the float32 prefills) and their share of dropped slots
               at capacity 1.25; whisper's serve pass again with zero
               frames (the reference CLI's), whose tokens must differ.
 14. train   — the training path: smollm-360m's published config (bf16
               weights, f32 moments, remat per layer group) for 8 AdamW
               steps at batch 8 x seq 256 through train_lib (each step's
               loss, lr, grad norm and wall, tokens/s, peak memory, one
               step under torch.profiler); the reference driver's
               documented run (`launch/train`, train_100m, float32) for
               80 steps, whose loss must fall; the same run crashed at
               step 50 and resumed from its step-40 checkpoint, each
               loss within 2e-4 relative of the uninterrupted run's;
               float32 loss and gradients at full width and one layer,
               card against CPU, with a TF32 control; the train_lm
               example (checkpoint at the midpoint, resumed).
 15. parallel — the parallel substrate: the hades-cmp dry-run cell's
               per-device program on the card at every HADES shape on
               both meshes (32 x 8 and 2 x 32 x 8: 1,024 - 32,768
               paper-bfv gadget lanes through the gadget Eval; wall,
               peak memory beside the dry-run's estimate and roofline
               step time), every gadget Eval shape against its plain
               version (tolerance 0), launches reconciled; the dry-run
               (`launch/dryrun.py`, started on the host when the script
               starts, at the lowest priority) of smollm-360m, internlm2-20b
               and deepseek-moe-16b train_4k, minicpm3-4b decode_32k,
               recurrentgemma-9b long_500k, xlstm-125m prefill_32k and
               hades-cmp cmp_1m on both meshes, every cell [ok], each
               per-device peak and the report's tables printed
               (estimates for an H100 cluster from a traced program);
               the train phase's (a) steps again under the one-rank
               mesh `launch/train` builds (a one-rank NCCL group),
               losses bit-equal, and the reduced smollm and
               deepseek-moe forward under it equal to the plain one.
 16. examples — the HADES examples on the card
               (`repro_torch.examples`): the quickstart, the range query
               at 2,048 hg38 rows (parts 1-5) and the trace smoke, each
               answer against the plaintext and every trace check; every
               distinct kernel call they made held against its plain
               version on the examples' own operands (tolerance 0, n =
               256 and 512), the checked launches reconciled with the
               counts.
 17. card    — the card's name and power limit (nvidia-smi), then one
               {"kernels": [...]} line with every kernel's numbers (the
               n = 16,384 shapes as rows named with the profile, the
               float path's as "...@paper-ckks/db" and its sharded
               tables' as "...@paper-ckks/shard", the FAE parts' as
               "...@paper-bfv/fae" and "...@paper-ckks/fae", the HADES
               cells' largest shape as "eval_coeff0_gadget@hades-cmp").

Launch counts are zeroed just before each path (serve, keymul, write,
fae (a), shard, join, each placement mesh, loop, each loop_shard layout,
ckks, each ckks_shard layout, fae (b),
the lm bridge, train, the HADES cells, the examples)
and read just after; each path's kernels must have launched.  The LM families and the
training path launch none of the kernels: their modules are plain
PyTorch, as the reference's are plain JAX.  The last
line is the device record.  Any failure raises: the script then exits
non-zero without it, as it does with no CUDA device or without the
repository beside it.  It imports nothing of JAX or of `repro`.
"""
from __future__ import annotations

import contextlib
import gc
import hashlib
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

T0 = time.perf_counter()     # the script's start, for the phases' t_s
ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

PROFILE = "paper-bfv"
BATCH = 4
INDEX_ROWS = 4096
KEYMUL_LANES = 1024
WRITE_SHARE = 0.05          # the write benchmark's insert share
WRITE_STEPS = 4
SHARDS = 4
SHARD_TOPK = 8              # the sharded benchmark's k
SHARD_INSERT = 431
JOIN_CUT = (8192, 4096)     # nested-loop cut: left x right rows
SEED = 0
# the serving-loop benchmark (benchmarks/serve_loop.py) at the pow2 pad
# full hg38 takes: 57,344 live rows a tenant
LOOP_PROFILE = "paper-bfv"
LOOP_ROWS = 65536
LOOP_ROUNDS = 4
LOOP_INSERT_CHUNK = 8
LOOP_COMPACT_AT = 32
# the LM serve path (the reference CLI's defaults) and its top-k bridge
LM_ARCH = "smollm_360m"
LM_REDUCED = False
LM_REQUESTS, LM_BATCH, LM_PROMPT, LM_GEN = 8, 4, 32, 16
LM_DECODE_CHECK = 4
# float32 prefill, card vs CPU, / max |logit|: about 10x the sound
# reading on an H100 and below the same prefill with TF32 matmuls
LM_CPU_REL_TOL = 2e-5
LM_DECODE_TOL = 2e-2        # tests/test_serve.py's decode vs forward
LM_PROFILE = "paper-ckks"
LM_CANDIDATES = 4096
LM_TOPK = 8
# float columns through the engine (benchmarks/db_engine.py::run_ckks and
# benchmarks/fig2_ckks.py at the paper's CKKS profile, gadget mode):
# values on the CKKS_GRID lattice in [0, 1000] (exact plaintext answers,
# far above the profile's ~2^-7 equality tolerance); table (a) is the
# bitcoin stand-in's 1,085 rows, table (b) hg38's first CKKS_ROWS rows
# (8 GiB a column: the bitonic build holds ~4 columns, so the full
# 34,423 rows, 32 GiB a column once padded, would not fit); CKKS_MICRO
# values for fig2's micro-operations, CKKS_INSERT rows inserted into (b)
# (5 %, the write benchmark's share) and CKKS_DELETE deleted
CKKS_PROFILE = "paper-ckks"
CKKS_GRID = 0.25
CKKS_ROWS = 16384
CKKS_MICRO = 100
CKKS_RANGES = 4
CKKS_INSERT = 819
CKKS_DELETE = 8
CKKS_SHARD_CUT = 1024       # (b)'s rows in the sharded nested cross-check
# FAE tables (phase fae): w = v // FAE_BIN gives ~1,000 tie classes of
# ~34 rows over hg38; Finding F2 over FAE_PAIRS pairs, whose Alg. 4
# flip share must lie within 6σ of 1/2 (σ = 0.5 / sqrt(FAE_PAIRS))
FAE_BIN = 64
FAE_TOPK = 8
FAE_ORDER_ROWS = 2000
FAE_PAIRS = 4096
FAE_FLIP_BAND = (0.45, 0.55)
FAE_NOISE_LANES = 1024
# the LM families beyond dense GQA, each at its published config, with
# the smollm phase's traffic: MLA, MoE, RG-LRU with local attention,
# xLSTM, the whisper encoder with cross attention, llava's patch prefix
# (its prompt LM_PROMPT tokens past the 576 patches)
LM_FAMILIES = ("minicpm3_4b", "deepseek_moe_16b", "recurrentgemma_9b",
               "whisper_base", "xlstm_125m", "llava_next_34b")
# cuts of an earlier path's depth that keep the script's time (printed
# with the phase as "depth_cut"): the two deepest earlier families at
# half their layers (a decode trace's processing grows with its kernels)
LM_FAMILY_LAYERS = {"minicpm3_4b": 31, "deepseek_moe_16b": 14}
# card memory a family's bf16 weights leave free for its caches, the
# float32 one-group check (llava: 5.9 GB) and activations; a family
# whose weights would leave less is cut to fewer layer groups (printed)
LM_FAMILY_HEADROOM = 10 * 2**30
# the training path: smollm-360m's published config (bf16 weights, f32
# moments, remat) for TRAIN_FULL_STEPS steps at batch x seq through
# train_lib; then the reference driver's documented run (train_100m)
# through launch/train for TRAIN_STEPS steps, whose mean loss over its
# last 5 steps must lie TRAIN_LOSS_MARGIN below that of its first 5;
# the same run crashed at TRAIN_FAIL_AT (checkpoints every
# TRAIN_CKPT_EVERY) and resumed, its losses within TRAIN_RESUME_RTOL of
# the uninterrupted run's (tests/test_fault_tolerance.py's bound);
# float32 loss and gradients at full width and one layer, card vs CPU
# (relative error of the loss, relative norm of the gradients'
# difference) under TRAIN_F32_REL_TOL with a TF32 control above it;
# the train_lm example at TRAIN_EXAMPLE_STEPS steps
TRAIN_ARCH = "smollm_360m"
TRAIN_BATCH, TRAIN_SEQ = 8, 256
TRAIN_FULL_STEPS = 8
TRAIN_STEPS = 80
TRAIN_LOSS_MARGIN = 0.5
TRAIN_FAIL_AT, TRAIN_CKPT_EVERY = 50, 20
TRAIN_RESUME_RTOL = 2e-4
TRAIN_F32_BATCH, TRAIN_F32_SEQ = 2, 64
TRAIN_F32_REL_TOL = 1e-5        # ~7x the reading, 1.41e-6 (H100)
TRAIN_EXAMPLE_STEPS = 40
# the examples phase's hg38 rows (the range query's parts 2 and 4)
EXAMPLE_ROWS = 2048
# the parallel phase: the dry-run cells traced on the host (each on both
# meshes, one process per group, started when the script starts and read
# after the train phase), one group per line; and the reduced configs
# whose forward runs under the one-rank mesh
DRYRUN_GROUPS = (
    (("internlm2-20b", "train_4k"),),
    (("deepseek-moe-16b", "train_4k"),),
    (("smollm-360m", "train_4k"), ("recurrentgemma-9b", "long_500k")),
    (("xlstm-125m", "prefill_32k"), ("minicpm3-4b", "decode_32k"),
     ("hades-cmp", "cmp_1m")),
)
DRYRUN_LIMIT_S = 900
MESH_FORWARD_ARCHS = ("smollm_360m", "deepseek_moe_16b")

# H100 SXM published memory rate (NVIDIA data sheet, at 700 W)
HBM_BYTES_PER_S = 3.35e12
# INT32 lanes per SM on Hopper (NVIDIA H100 Tensor Core GPU Architecture
# whitepaper: 16 in each of the SM's 4 partitions, against 32 FP32
# lanes).  The kernels' 32 x 32 -> 64-bit integer multiply-adds issue
# at most one per such lane and clock, so SMs x 64 x the maximum SM
# clock is the most the card can do of them.
INT32_LANES_PER_SM = 64
# dense INT8 tensor-core operations per second of one H100 SXM (NVIDIA
# data sheet, without sparsity, at 700 W): the gadget Eval's u8 product
INT8_TC_OPS_PER_S = 1979e12
# dense bf16 tensor-core FLOP/s of one H100 SXM (the same data sheet):
# the training step's matmuls
BF16_TC_FLOP_PER_S = 989e12


# the kernels each driven path must launch: keygen's a*sk is the multiply
# with two varying operands, its eval-domain gadget CEK and the key
# transforms (KeySet.key_br, once per key) run the forward NTT, and every
# encryption and decryption the multiply against a key transform
SERVE_KERNELS = ("eval_coeff0_gadget", "negacyclic_mul_ntt",
                 "negacyclic_mul", "ntt_br_fwd")
KEYMUL_KERNELS = ("ntt_br_fwd", "ntt_br_inv")
WRITE_KERNELS = ("eval_coeff0_paper", "negacyclic_mul_ntt",
                 "negacyclic_mul", "ntt_br_fwd")
# the shard path encrypts its pad and insert rows and scans, sorts and
# probes through the gadget Eval; the join path encrypts its tables and
# runs both Evals (gadget sort-merge and nested cut, paper nested cut)
SHARD_KERNELS = ("eval_coeff0_gadget", "negacyclic_mul_ntt")
PLACEMENT_KERNELS = ("eval_coeff0_gadget", "eval_coeff0_paper",
                     "negacyclic_mul_ntt")
JOIN_KERNELS = ("eval_coeff0_gadget", "eval_coeff0_paper",
                "negacyclic_mul_ntt")
# the loop runs paper keygen, encryption and the paper Eval; the LM
# bridge paper-ckks gadget keygen, encryption and the gadget Eval
LOOP_KERNELS = ("eval_coeff0_paper", "negacyclic_mul_ntt", "negacyclic_mul",
                "ntt_br_fwd")
# the sharded loop encrypts its table, queries and inserts and runs the
# paper Eval (keys made before its launch counts are zeroed)
LOOP_SHARD_KERNELS = ("eval_coeff0_paper", "negacyclic_mul_ntt")
LM_KERNELS = ("eval_coeff0_gadget", "negacyclic_mul_ntt", "negacyclic_mul",
              "ntt_br_fwd")
# the examples run gadget and paper keygen, encryption and both Evals
EXAMPLE_KERNELS = ("eval_coeff0_gadget", "eval_coeff0_paper",
                   "negacyclic_mul_ntt", "negacyclic_mul", "ntt_br_fwd")
# the float path runs gadget keygen, encryption and the gadget Eval
CKKS_KERNELS = ("eval_coeff0_gadget", "negacyclic_mul_ntt", "negacyclic_mul",
                "ntt_br_fwd")
# the sharded float phase reuses the float phase's keys: no keygen
CKKS_SHARD_KERNELS = ("eval_coeff0_gadget", "negacyclic_mul_ntt")
# the FAE parts reuse the serve and float phases' keys: encryption and
# the gadget Eval
FAE_KERNELS = ("eval_coeff0_gadget", "negacyclic_mul_ntt")


def emit(obj) -> None:
    """Print one JSON line; a phase's line carries the script's seconds
    so far (`t_s`), so each phase's share of the wall reads off."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T0}
    print(json.dumps(obj), flush=True)


def time_cuda(fn, reps: int) -> float:
    """Milliseconds per call by CUDA events, after one warm-up call."""
    from repro_torch.kernels.timing import events_ms
    return events_ms(fn, reps)


def max_abs_err(a, b) -> int:
    return int((a - b).abs().max().item()) if a.numel() else 0


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# bounds: the least time the card could take for the same work
# ---------------------------------------------------------------------------

def int_mac_rate() -> dict:
    """The card's integer multiply-add rate: SM count (torch) x
    INT32_LANES_PER_SM x maximum SM clock (nvidia-smi)."""
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60)
    mhz = float(smi.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return {"sms": sms, "max_sm_mhz": mhz,
            "int_macs_per_s": sms * INT32_LANES_PER_SM * mhz * 1e6}


def _bound(nbytes: int, ops: int, ops_per_s: float) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": t_bytes, "ops_ms": t_ops,
            "bytes": nbytes, "ops": ops, "ops_per_s": ops_per_s}


def eval_bound(A: int, T: int, K: int, n: int, D: int, per_lane: bool,
               rate: dict) -> dict:
    """Gadget Eval over A atoms x T rows: read the tile's c1 and c0
    coefficient 0, the bounds (one per atom, or per lane) and cek_rev
    once, write [A, T, K]; the byte-split product is A*T lanes x (K n
    D4) digit bytes (D rounded up to whole 4-byte words) x 8 byte columns
    u8 multiply-adds, 2 operations each, at the dense INT8 tensor-core
    rate."""
    nb = A * T if per_lane else A
    nbytes = 8 * (T * K * n + T * K + nb * (K * n + K) + K * D * K * n
                  + A * T * K)
    words = -(-D // 4)
    d4 = 4 * (1 << (words - 1).bit_length())
    return _bound(nbytes, A * T * K * n * d4 * 8 * 2, INT8_TC_OPS_PER_S)


def mul_bound(B: int, K: int, n: int, b_rows: int, rate: dict, *,
              key_ntt: bool) -> dict:
    """Fused multiply over B rows: read a (and b, b_rows rows, or the
    key's transform as [K, n] 32-bit pairs) and the Shoup tables ([K, 4,
    n] pairs) once, write B rows; one multiply-add per modular multiply:
    per (row, tower) twists and pointwise 3n and n log2 n butterflies
    for two transforms (key_ntt), 4n and 1.5 n log2 n for three."""
    S = n.bit_length() - 1
    ops = 3 * n + n * S if key_ntt else 4 * n + 3 * (n // 2) * S
    b_bytes = 8 * K * n if key_ntt else 8 * b_rows * K * n
    nbytes = 8 * 2 * B * K * n + b_bytes + 8 * 4 * K * n
    return _bound(nbytes, B * K * ops, rate["int_macs_per_s"])


def ntt_bound(B: int, K: int, n: int, rate: dict) -> dict:
    """ntt_br over B rows (either direction): read x and its twist and
    twiddle pairs once, write B rows; n twist multiplies + n/2 log2 n
    butterflies per (row, tower)."""
    S = n.bit_length() - 1
    nbytes = 8 * (2 * B * K * n + 2 * K * n)
    return _bound(nbytes, B * K * (n + (n // 2) * S), rate["int_macs_per_s"])


def paper_bound(B: int, K: int, n: int, lane_form: bool, b_rows: int,
                rate: dict) -> dict:
    """Paper Eval over B lanes: read each lane's c1 and c0 coefficient 0
    (and b's, b_rows of them, in the lane form) and rev(cek) once, write
    [B, K]; one multiply-add per c1 coefficient."""
    rows = B + (b_rows if lane_form else 0)
    nbytes = 8 * (rows * (K * n + K) + K * n + K + B * K)
    return _bound(nbytes, B * K * n, rate["int_macs_per_s"])


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def _ptxas(log: str) -> list:
    """Registers, spills and stack of each kernel from `nvcc -Xptxas -v`
    output: [{kernel, registers, spill_stores, spill_loads, stack}]."""
    import re
    out, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            cur = {"kernel": m.group(1)}
            out.append(cur)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m and cur is not None:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    names = subprocess.run(["c++filt"], input="\n".join(
        k["kernel"] for k in out), capture_output=True, text=True,
        timeout=60).stdout.splitlines() if shutil.which("c++filt") else []
    for k, name in zip(out, names):
        k["kernel"] = name.split("(")[0]
    return out


def kernel_variants():
    """`tools/kernel_variants.py`: the C = 1 ntt_br build (`start_c1`) and
    the timing harness (`time_turns`, `ntt_call`)."""
    sys.path.insert(0, str(ROOT / "tools"))
    import kernel_variants as KV
    return KV


# the C = 1 ntt_br library ("lib"), built by phase_build beside the
# package's: ntt_br's forms are timed against it
C1: dict = {}


def phase_build() -> dict:
    """Build every library, and the C = 1 ntt_br of `tools/ntt_c1.cu`
    beside them (all nvcc processes at once); each kernel's registers
    and spills, and the tensor-core instructions (IMMA) in the gadget
    Eval's machine code."""
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    c1_done = kernel_variants().start_c1(_build.BUILD_DIR / "ntt_c1")
    per_source = _build.build_all()
    for name in _build.SOURCES:
        _build.load(name)
    C1["lib"] = c1_done()
    out = {"phase": "build", "seconds": time.perf_counter() - t0,
           "kernels": list(_build.SOURCES), "per_source_s": per_source}
    for name in _build.SOURCES:
        log = _build.BUILD_DIR / f"{name}.log"
        if log.exists():
            out[f"ptxas_{name}"] = _ptxas(log.read_text())
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(_build._lib_path(
        "cmp_eval"))], capture_output=True, text=True, timeout=300).stdout
    out["imma_instructions_cmp_eval"] = sum("IMMA" in ln
                                            for ln in sass.splitlines())
    emit(out)
    require(out["imma_instructions_cmp_eval"] > 0,
            "the gadget Eval has no tensor-core (IMMA) instruction")
    return out


def phase_kernels(ks, table, serve, rate) -> dict:
    """Each kernel vs its plain version, after the main path, on its
    inputs and at every shape it gave the kernels.

    Eval, over the served column itself: for every atom count A of a
    served batch, its first and last row tile (T = lane_tile(W, A)
    rows, so the column's first and last slots) against A random
    bounds; a 1,024-lane tile with per-lane bounds (the sort and probe
    layout); and, over 256 rows of a random two-column stack, atom
    counts that reach every atom-chunk width of the kernel, a partial
    last chunk, and the wrapper's split by column; and a 1,024-lane tile
    whose differences are all q - 1 (bound = c1 + 1), the largest digits.
    Multiply against a key transform (negacyclic_mul_ntt): pk0, pk1 and
    sk at every row count the paths give it (an encryption chunk of
    8,192, the column's last chunk, an insert chunk, a decrypted sample,
    one row); with two varying operands (negacyclic_mul): [64, 2, 4096]
    full and stride 0, and an encryption chunk against pk0."""
    import torch
    from repro_torch.core import sampling
    from repro_torch.core.encrypt import ENC_CHUNK_ROWS
    from repro_torch.kernels import cmp_eval as CK
    from repro_torch.kernels import ntt as NK
    from repro_torch.kernels import _build
    from repro_torch.kernels import ops as KO

    params, ring = ks.params, ks.ring
    K, n = params.num_towers, params.n
    _build.reset_launch_counts()
    D = params.gadget_digits_per_tower
    lb = params.profile.gadget_log_base
    gen = sampling.make_generator(SEED + 7, ks.device)
    W = table.scan_width
    qs = ring.q_arr[:, 0]
    col = table.scan_column("value")
    served = [(A, KO.lane_tile(W, A)) for A in
              dict.fromkeys(b["scan_compares"] // W for b in serve["batches"])]
    require(all(b["scan_compares"] % W == 0 for b in serve["batches"]),
            "a served batch's compares are not whole scans")

    def ev(kernel, uniq, off, rows, sel, b0, b1):
        args = (uniq[0], uniq[1], off, rows, sel, b0, b1, ks.cek_rev, qs,
                params.scale, lb)
        if kernel:
            return CK.eval_coeff0_gadget(*args, cek_bytes=ks.cek_rev_bytes)
        return CK.eval_coeff0_gadget_plain(*args)

    def bounds(*shape):
        return (sampling.uniform_poly(params, gen, shape),
                sampling.uniform_poly(params, gen, shape))

    table_stack = (col.c0[None], col.c1[None])
    pair = sampling.uniform_poly(params, gen, (2, 2, 256))
    pair_stack = (pair[0], pair[1])
    cases, tiles = [], []
    for A, T in served:
        b = bounds(A)
        tiles.append((A, T, b))
        for off in (0, W - T):
            cases.append((table_stack, off, T, [0] * A, *b))
    lanes = min(1024, W)
    per_lane = (table_stack, W - lanes, lanes, [0], *bounds(1, lanes))
    cases.append(per_lane)
    top = slice(W - lanes, W)           # d = q - 1 on every coefficient
    cases.append((table_stack, W - lanes, lanes, [0], col.c0[None, top],
                  ((col.c1[top] + 1) % ring.q_arr)[None]))
    for A in (1, 2, 3, 4, 5, 8, 9, 17):
        cases.append((pair_stack, 0, 256, [0] * A, *bounds(A)))
    for A in (3, 10):
        cases.append((pair_stack, 0, 256, [a % 2 for a in range(A)],
                      *bounds(A)))
    errs, eq = [], True
    for case in cases:
        got, want = ev(True, *case), ev(False, *case)
        torch.cuda.synchronize()
        eq &= torch.equal(got, want)
        errs.append(max_abs_err(got, want))
    require(eq, f"Eval kernel != plain (max |err| {errs})")
    timed = []
    for A, T, (b0, b1) in tiles:
        args = (table_stack, 0, T, [0] * A, b0, b1)
        timed.append({"atoms": A, "rows": T,
                      "ms": time_cuda(lambda: ev(True, *args), 5),
                      "plain_ms": time_cuda(lambda: ev(False, *args), 1),
                      **eval_bound(A, T, K, n, D, False, rate)})
    pl_ms = time_cuda(lambda: ev(True, *per_lane), 20)
    del cases, tiles, pair, pair_stack, per_lane

    a64 = sampling.uniform_poly(params, gen, (64,))
    b64 = sampling.uniform_poly(params, gen, (64,))
    mul_eq, mul_errs = True, []

    def held(got, want):
        nonlocal mul_eq
        torch.cuda.synchronize()
        mul_eq &= torch.equal(got, want)
        mul_errs.append(max_abs_err(got, want))
    for b in (b64, ks.pk0):
        held(NK.negacyclic_mul(a64, b, ring),
             NK.negacyclic_mul_plain(a64, b, ring))
    u = sampling.ternary_poly(params, gen, (ENC_CHUNK_ROWS,))
    held(NK.negacyclic_mul(ks.pk0, u, ring),
         NK.negacyclic_mul_plain(ks.pk0, u, ring))
    last_chunk = table.n_rows % ENC_CHUNK_ROWS or ENC_CHUNK_ROWS
    shapes = (ENC_CHUNK_ROWS, last_chunk, 431, 256, 1)
    for name in ("pk0", "pk1", "sk"):
        br, pairs = ks.key_br(name)
        for rows in shapes:
            x = (u[:rows] if name != "sk"
                 else sampling.uniform_poly(params, gen, (rows,)))
            held(NK.negacyclic_mul_ntt(x, br, ring, pairs),
                 NK.negacyclic_mul_ntt_plain(x, br, ring))
    br, pairs = ks.key_br("pk0")
    mul_ntt = {"ms": time_cuda(
        lambda: NK.negacyclic_mul_ntt(u, br, ring, pairs), 10),
        "plain_ms": time_cuda(
            lambda: NK.negacyclic_mul_ntt_plain(u, br, ring), 1),
        **mul_bound(ENC_CHUNK_ROWS, K, n, 1, rate, key_ntt=True)}
    mul_var = {"ms": time_cuda(lambda: NK.negacyclic_mul(u, ks.pk0, ring),
                               10),
               "plain_ms": time_cuda(
                   lambda: NK.negacyclic_mul_plain(u, ks.pk0, ring), 1),
               **mul_bound(ENC_CHUNK_ROWS, K, n, 1, rate, key_ntt=False)}
    mul64_ms = time_cuda(lambda: NK.negacyclic_mul(a64, b64, ring), 20)
    del u
    require(mul_eq, f"multiply kernel != plain (max |err| {mul_errs})")
    torch.cuda.empty_cache()

    out = {
        "phase": "kernels", "tolerance": 0, "rate": rate,
        "launches": dict(_build.LAUNCHES),
        "eval": {"equal": eq, "max_abs_err": max(errs),
                 "cases": len(errs), "served_tiles": timed,
                 "per_lane_1024_ms": pl_ms},
        "mul": {"equal": mul_eq, "max_abs_err": max(mul_errs),
                "cases": len(mul_errs), "key_rows": list(shapes),
                "shape": [ENC_CHUNK_ROWS, K, n], "key_ntt": mul_ntt,
                "var": mul_var, "ms_64x64": mul64_ms},
    }
    emit(out)
    return out


def _requests(ks, vals, rng):
    """8 requests: 6 Range, 2 Eq; one Range and one Eq inside an Or/And."""
    from repro_torch.core import encrypt as E
    from repro_torch.db import plan as P

    seeds = iter(range(1000, 2000))

    def enc(v):
        return E.encrypt(ks, int(v), next(seeds))

    def rng_pair(width):
        lo = int(rng.integers(0, 65537 - width))
        return lo, lo + width

    dup = np.unique(vals, return_counts=True)
    dups = dup[0][dup[1] > 1]
    reqs = []
    for width in (50, 500, 5000, 20000, 65536):
        lo, hi = rng_pair(min(width, 65536))
        reqs.append((P.Range("value", enc(lo), enc(hi)),
                     lambda x, lo=lo, hi=hi: (x >= lo) & (x <= hi)))
    (a, b), v = rng_pair(300), int(dups[0])
    reqs.append((P.Or(P.Range("value", enc(a), enc(b)),
                      P.Eq("value", enc(v))),
                 lambda x, a=a, b=b, v=v: ((x >= a) & (x <= b)) | (x == v)))
    v = int(dups[len(dups) // 2])
    reqs.append((P.Eq("value", enc(v)), lambda x, v=v: x == v))
    lo, hi = rng_pair(30000)
    reqs.append((P.And(P.Not(P.Range("value", enc(lo), enc(hi))),
                       P.Range("value", enc(0), enc(40000))),
                 lambda x, lo=lo, hi=hi: ~((x >= lo) & (x <= hi))
                 & (x <= 40000)))
    return reqs


def phase_serve(dev) -> tuple:
    """The main path, with every launch count zeroed just before it."""
    import torch
    from repro_torch import obs
    from repro_torch.core.keys import keygen
    from repro_torch.core.params import make_params
    from repro_torch.data import load_dataset
    from repro_torch.db.query_serve import QueryServer
    from repro_torch.db.table import Table
    from repro_torch.kernels import _build

    params = make_params(PROFILE, mode="gadget")
    vals = load_dataset("hg38", scheme="bfv", t=params.t)
    # warm-up over the first INDEX_ROWS rows with other keys: loads
    # every kernel and PyTorch op of the path, so the times below are
    # not those of a cold process
    wks = keygen(params, SEED + 5, device=dev)
    warm = QueryServer(wks, Table.from_arrays(
        wks, "warm", {"value": vals[:INDEX_ROWS]}, SEED + 6), batch=BATCH)
    for q, _ in _requests(wks, vals, np.random.default_rng(SEED + 5)):
        warm.submit(q)
    warm.run()
    del wks, warm
    rng = np.random.default_rng(SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()

    t0 = time.perf_counter()
    ks = keygen(params, SEED, device=dev)
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    table = Table.from_arrays(ks, "hg38", {"value": vals}, SEED + 1)
    torch.cuda.synchronize()
    encrypt_s = time.perf_counter() - t0
    reqs = _requests(ks, vals, rng)
    server = QueryServer(ks, table, batch=BATCH)
    qids = [server.submit(q) for q, _ in reqs]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = server.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)

    correct = 0
    for qid, (_, truth) in zip(qids, reqs):
        want = np.nonzero(truth(vals))[0]
        correct += int(np.array_equal(results[qid].row_ids, want))
    sample = np.unique(np.concatenate([[0, len(vals) - 1],
                                       rng.integers(0, len(vals), 254)]))
    from repro_torch.core import encrypt as E
    dec = E.decrypt(ks, table.gather("value", sample)).cpu().numpy()
    dec_ok = bool(np.array_equal(dec, vals[sample]))
    out = {
        "phase": "serve", "profile": PROFILE, "mode": "gadget",
        "rows": int(len(vals)), "n_padded": table.n_padded,
        "table_bytes": table.ciphertext_bytes(),
        "requests": len(reqs), "batch": BATCH,
        "correct": f"{correct}/{len(reqs)}",
        "decrypt_sample_ok": dec_ok, "decrypt_sample_rows": len(sample),
        "keygen_s": keygen_s, "encrypt_s": encrypt_s,
        "serve_wall_s": wall, "queries_per_s": len(reqs) / wall,
        "batches": [{"queries": b.queries, "scan_compares": b.scan_compares,
                     "wall_s": b.wall_s} for b in server.batch_log],
        "eval_lanes": sum(b.scan_compares for b in server.batch_log),
        "launches": launches,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
    }
    emit(out)
    require(correct == len(reqs), f"serve answered {out['correct']}")
    require(dec_ok, "decrypted sample != data")
    require(all(launches[k] > 0 for k in SERVE_KERNELS),
            f"a kernel never launched on the serve path: {launches}")
    return ks, table, vals, reqs, out


def phase_profile(ks, table, reqs, serve) -> dict:
    """The same 8 requests again, traced (`obs.tracing`) and under
    `torch.profiler`: the engine's counters, span totals, device busy
    time and share, and device time by kernel name.  Not the main
    path's measurement (tracing synchronizes per tile); where the
    profiler records no device activity the device numbers are null."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs
    from repro_torch.db.query_serve import QueryServer

    server = QueryServer(ks, table, batch=BATCH)
    for q, _ in reqs:
        server.submit(q)
    torch.cuda.synchronize()
    with obs.tracing() as tracer, profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        server.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        lanes = obs.REGISTRY.value("eval.lanes")
        tiles = obs.REGISTRY.value("eval.tiles")
    spans = _span_ms(tracer)
    dev = _device_summary(prof, wall, top=8)
    out = {"phase": "profile", "traced_wall_s": wall,
           "eval_lanes": lanes, "eval_tiles": tiles,
           "span_ms": spans,
           "device_events": dev["events"],
           "device_busy_s": dev["busy_s"],
           "device_busy_share": dev["busy_share"],
           "device_ms_by_name": dev["ms_by_name"]}
    emit(out)
    require(lanes == serve["eval_lanes"],
            f"traced eval.lanes {lanes} != served {serve['eval_lanes']}")
    return out


def phase_index(ks, table, vals) -> dict:
    """SortedIndex over the first INDEX_ROWS rows, reusing their
    ciphertexts, then point lookups and ranges vs the plaintext truth."""
    import torch
    from repro_torch.core import encrypt as E
    from repro_torch.db.index import SortedIndex
    from repro_torch.db.table import Table
    from repro_torch.kernels import _build

    rows = np.arange(INDEX_ROWS)
    sub = Table.from_ciphertexts("hg38_head", {"value": table.gather(
        "value", rows)}, INDEX_ROWS)
    v = vals[:INDEX_ROWS]
    _build.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx = SortedIndex.build(ks, sub, "value")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_launches = dict(_build.LAUNCHES)
    ok = bool(np.array_equal(v[idx.perm], np.sort(v)))
    rng = np.random.default_rng(SEED + 3)
    t0 = time.perf_counter()
    for x in list(rng.choice(v, 3)) + [70000]:
        got = np.sort(idx.point_lookup(ks, E.encrypt(ks, int(x), int(x))))
        ok &= bool(np.array_equal(got, np.nonzero(v == x)[0]))
    for lo, hi in ((1000, 9000), (30000, 30500)):
        got = np.sort(idx.search_range(ks, E.encrypt(ks, lo, lo),
                                       E.encrypt(ks, hi, hi)))
        ok &= bool(np.array_equal(got, np.nonzero((v >= lo) & (v <= hi))[0]))
    torch.cuda.synchronize()
    out = {"phase": "index", "rows": INDEX_ROWS, "correct": ok,
           "build_s": build_s, "build_compares": idx.build_compares,
           "build_launches": build_launches,
           "lookups_s": time.perf_counter() - t0,
           "search_compares": idx.search_compares}
    emit(out)
    require(ok, "index answers differ from the plaintext truth")
    return out


def phase_keymul(ks, table, rate) -> dict:
    """gadget_keymul over KEYMUL_LANES served lanes, its NTTs on the
    ntt_br kernels (launch counts zeroed just before, read just after),
    cross-checked against the gadget Eval kernel; then ntt_br against its
    plain version at every shape it runs at, and timed."""
    import torch
    from repro_torch.core import compare as C
    from repro_torch.core import encrypt as E
    from repro_torch.core import gadget as G
    from repro_torch.core import ring as R
    from repro_torch.core import sampling
    from repro_torch.core.encrypt import Ciphertext
    from repro_torch.core.params import make_params
    from repro_torch.kernels import _build
    from repro_torch.kernels import cmp_eval as CK
    from repro_torch.kernels import ntt as NK
    from repro_torch.kernels import timing

    params, ring = ks.params, ks.ring
    K, n, D = params.num_towers, params.n, params.gadget_digits_per_tower
    qs = ring.q_arr[:, 0]
    rows = KEYMUL_LANES
    col = table.scan_column("value")
    bound = E.encrypt(ks, 30000, SEED + 11)
    lanes = Ciphertext(col.c0[:rows], col.c1[:rows])
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    d = C.ct_sub(ring, lanes, Ciphertext(bound.c0[None], bound.c1[None]))
    keyed = G.gadget_keymul(ks, d.c1)
    via_ntt = R.add(ring, R.scalar_mul(ring, d.c0, params.scale),
                    keyed)[..., 0]
    torch.cuda.synchronize()
    keymul_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    via_eval = CK.eval_coeff0_gadget(
        col.c0[None], col.c1[None], 0, rows, [0], bound.c0[None],
        bound.c1[None], ks.cek_rev, qs, params.scale,
        params.profile.gadget_log_base)[0]
    torch.cuda.synchronize()
    cross_equal = bool(torch.equal(via_ntt, via_eval))
    del d, keyed, via_ntt, via_eval

    gen = sampling.make_generator(SEED + 12, ks.device)
    ckks = make_params("paper-ckks")
    cring = R.make_ring(ckks, ks.device)
    digits = sampling.uniform_poly(params, gen, (rows * K * D,))
    card = NK.card_shape(ks.device.index)
    ck_pool = sampling.uniform_poly(
        ckks, gen, (max(NK.plan_boundaries(K, ckks.n, *card)),))
    # every shape of the ntt_br table in PERF.md, and the row counts on
    # each side of every change of the card's plan at both degrees
    cases = [("keygen cek_gadget", ks.cek_gadget.reshape(-1, K, n), ring),
             ("paper-ckks keygen cek", ck_pool[:8], cring),
             ("paper-ckks key_br", ck_pool[:1], cring),
             ("paper-ckks [4]", ck_pool[:4], cring),
             ("keymul digits", digits, ring),
             ("keymul sum", digits[:rows], ring),
             ("[33]", digits[:33], ring),
             *((f"edge {r}", digits[:r], ring)
               for r in NK.plan_boundaries(K, n, *card)),
             *((f"paper-ckks edge {r}", ck_pool[:r], cring)
               for r in NK.plan_boundaries(K, ckks.n, *card))]
    eq, errs = True, []
    for _, x, rg in cases:
        for fwd in (True, False):
            got = NK.ntt_br(x, rg, fwd=fwd)
            want = NK.ntt_br_plain(x, rg, fwd=fwd)
            torch.cuda.synchronize()
            eq &= torch.equal(got, want)
            errs.append(max_abs_err(got, want))
        eq &= torch.equal(NK.ntt_br(NK.ntt_br(x, rg), rg, fwd=False), x)
    torch.cuda.synchronize()
    floor = timing.launch_floor(ks.device)
    shapes = [ntt_form_times(name, x, rg, fwd, rate)
              for name, x, rg in cases for fwd in (True, False)]
    # the kernels line's times at the keymul path's shapes: forward over
    # its K*D digit polynomials per lane, inverse over one per lane
    timed = {}
    for name, x, fwd in (("fwd", digits, True), ("inv", digits[:rows], False)):
        got = next(t for t in shapes
                   if t["shape"] == list(x.shape) and t["fwd"] == fwd)
        timed[name] = {**got, "plain_ms": time_cuda(
            lambda: NK.ntt_br_plain(x, ring, fwd=fwd), 1)}
    timed["fwd_keygen_ms"] = time_cuda(
        lambda: NK.ntt_br(cases[0][1], ring), 20)
    timed["fwd_keygen_device_ms"] = shapes[0]["ms"]
    del digits, cases, ck_pool
    torch.cuda.empty_cache()
    out = {"phase": "keymul", "lanes": rows, "cross_equal": cross_equal,
           "keymul_s": keymul_s, "launches": launches, "ntt_equal": eq,
           "max_abs_err": max(errs), "ntt_cases": len(errs),
           "launch_floor": floor, "ntt_shapes": shapes, **timed}
    emit(out)
    require(cross_equal, "coeff0 of gadget_keymul != the gadget Eval")
    require(eq, f"ntt_br kernel != plain (max |err| {errs})")
    require(all(t["c1_equal"] for t in shapes),
            "the C = 1 ntt_br (tools/ntt_c1.cu) != plain")
    require(floor["saturated"] and all(
        t["saturated"] for t in shapes if "saturated" in t),
        "a host-time batch of ntt_br outlasted the card's sleep")
    require(all(launches[k] > 0 for k in KEYMUL_KERNELS),
            f"an NTT kernel never launched on the keymul path: {launches}")
    return out


def ntt_form_times(name, x, ring, fwd: bool, rate) -> dict:
    """ntt_br at x's shape in the card's planned form and as the C = 1
    kernel (`tools/ntt_c1.cu`, one block per (polynomial, tower), the
    design before the cluster and wide forms), that one held against the
    plain version, timed in turns (C = 1, planned, planned, C = 1) by
    `tools/kernel_variants.py::time_turns` beside the bound: where a
    call moves less than 64 MiB (there the host's launch is as long as
    the kernel) the device time by CUDA-graph replay, with the planned
    form's host time and events time (`timing.split`), above it CUDA
    events."""
    import torch
    from repro_torch.kernels import ntt as NK
    KV = kernel_variants()
    K, n = x.shape[-2:]
    rows = int(np.prod(x.shape[:-2]))
    launch = NK.plan(rows, K, n, *NK.card_shape(x.device.index), fwd=fwd)
    c1 = KV.ntt_call(C1["lib"].hades_ntt_br_c1, x, ring, fwd)
    c1_equal = bool(torch.equal(c1(), NK.ntt_br_plain(x, ring, fwd=fwd)))
    t = KV.time_turns({"c1": c1,
                       "planned": lambda: NK.ntt_br(x, ring, fwd=fwd)},
                      16 * rows * K * n, split="planned")
    ms, c1_ms = t.pop("planned_ms"), t.pop("c1_ms")
    return {"case": name, "shape": list(x.shape), "fwd": fwd,
            "plan": list(launch), "ms": ms, "c1_ms": c1_ms,
            "vs_c1": ms / c1_ms, "c1_equal": c1_equal, **t,
            **ntt_bound(rows, K, n, rate)}


def phase_write(dev, vals) -> tuple:
    """The paper-mode write path (the write benchmark's traffic over the
    full column), with every launch count zeroed just before it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs
    from repro_torch.core import encrypt as E
    from repro_torch.core.compare import next_pow2
    from repro_torch.core.keys import keygen
    from repro_torch.core.params import make_params
    from repro_torch.db import execute, compact
    from repro_torch.db import plan as P
    from repro_torch.db.index import SortedIndex
    from repro_torch.db.query_serve import QueryServer
    from repro_torch.db.table import Table
    from repro_torch.kernels import _build

    params = make_params(PROFILE, mode="paper")
    seeds = iter(range(5000, 6000))

    def enc(v):
        return E.encrypt(ks, int(v), next(seeds))

    def sync_s(t0):
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    pshapes, pstop = record_paper_shapes()
    walls = {}
    with obs.tracing() as tracer:
        t0 = time.perf_counter()
        ks = keygen(params, SEED + 20, device=dev, paper_ecek_weight=0)
        walls["keygen_s"] = sync_s(t0)
        t0 = time.perf_counter()
        table = Table.from_arrays(ks, "hg38_w", {"value": vals}, SEED + 21)
        walls["encrypt_s"] = sync_s(t0)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            idx = SortedIndex.build(ks, table, "value")
            walls["index_build_s"] = sync_s(t0)
        build_dev = _device_summary(prof, walls["index_build_s"])
        del prof
        build_ok = bool(np.array_equal(vals[idx.perm], np.sort(vals)))
        indexes = {"value": idx}
        n = len(vals)
        rng = np.random.default_rng(7)
        m = max(8, round(WRITE_SHARE * n))

        # ---- sustained ingest while serving (FIFO mutation queue) ------
        server = QueryServer(ks, table, indexes=indexes, batch=BATCH)
        all_vals, alive = vals.copy(), np.ones(n, bool)
        chunks = np.array_split(rng.choice(vals, m), WRITE_STEPS)
        qok = gid_ok = True
        t0 = time.perf_counter()
        for i, chunk in enumerate(chunks):
            ins = server.submit_insert({"value": chunk}, SEED + 1000 + i)
            lo, hi = (int(v) for v in np.sort(rng.choice(vals, 2,
                                                         replace=False)))
            qid = server.submit(P.Range("value", enc(lo), enc(hi)))
            res = server.run()
            start = len(all_vals)
            all_vals = np.concatenate([all_vals, chunk])
            alive = np.concatenate([alive, np.ones(len(chunk), bool)])
            gid_ok &= np.array_equal(res[ins].row_ids,
                                     np.arange(start, start + len(chunk)))
            qok &= np.array_equal(
                res[qid].mask, (all_vals >= lo) & (all_vals <= hi) & alive)
        walls["insert_serve_s"] = sync_s(t0)
        # a tombstone mid-stream: the very next query must exclude it
        dead = [n // 2, n // 2 + 1]
        t0 = time.perf_counter()
        did = server.submit_delete(dead)
        qid = server.submit(P.Range("value", enc(all_vals.min()),
                                    enc(all_vals.max())))
        res = server.run()
        walls["delete_query_s"] = sync_s(t0)
        alive[dead] = False
        tomb_ok = bool(res[did].deleted == len(dead)
                       and np.array_equal(res[qid].mask, alive))
        dbuild = sum(b.delta_build_compares for b in server.batch_log)

        # ---- the 8 served requests scanned over base ∪ delta -----------
        scan = QueryServer(ks, table, batch=BATCH)
        reqs = _requests(ks, vals, np.random.default_rng(SEED))
        qids = [scan.submit(q) for q, _ in reqs]
        t0 = time.perf_counter()
        sres = scan.run()
        walls["scan_requests_s"] = sync_s(t0)
        scan_correct = sum(
            int(np.array_equal(sres[q].row_ids,
                               np.nonzero(truth(all_vals) & alive)[0]))
            for q, (_, truth) in zip(qids, reqs))
        scan_batches = [{"queries": b.queries,
                         "scan_compares": b.scan_compares,
                         "wall_s": b.wall_s} for b in scan.batch_log]
        scan_width = table.scan_width
        del scan, sres

        # ---- union probe: base search + one per-run binary search ------
        target = int(all_vals[n + m // 2])          # lives in the delta run
        q_eq = P.Eq("value", enc(target))
        execute(ks, table, q_eq, indexes=indexes)              # warm
        t0 = time.perf_counter()
        for _ in range(2):
            res = execute(ks, table, q_eq, indexes=indexes)
        walls["union_probe_s"] = sync_s(t0) / 2
        want = (all_vals == target) & alive
        probe_ok = bool(np.array_equal(res.mask, want))
        n_b, n_d = next_pow2(table.n_rows), next_pow2(table.n_delta)
        probe_bound = 2 * 2 * (max(1, (n_b - 1).bit_length())
                               + max(1, (n_d - 1).bit_length()))
        probe_compares = res.stats.index_compares

        # ---- compaction: merge network, never a rebuild -----------------
        nb, nd = table.n_rows, table.n_delta
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            cstats = compact(ks, table, indexes)
            walls["compact_s"] = sync_s(t0)
        L = next_pow2(max(nb, nd))
        merge_bound = cstats.merge_rounds * L * (1 + max(1,
                                                         L.bit_length() - 1))
        sorted_ok = bool(np.array_equal(all_vals[indexes["value"].perm],
                                        np.sort(all_vals)))
        execute(ks, table, q_eq, indexes=indexes)              # warm
        t0 = time.perf_counter()
        for _ in range(2):
            post = execute(ks, table, q_eq, indexes=indexes)
        walls["post_probe_s"] = sync_s(t0) / 2
        post_ok = bool(np.array_equal(post.mask, want))
        launches = dict(_build.LAUNCHES)
        pstop()
        peak = torch.cuda.max_memory_allocated()
    spans = _span_ms(tracer)
    compact_dev = _device_summary(prof, walls["compact_s"])
    out = {
        "phase": "write", "profile": PROFILE, "mode": "paper",
        "rows_base": n, "rows_inserted": m, "steps": WRITE_STEPS,
        "n_padded": table.n_padded, "index_build_ok": build_ok,
        "index_build_compares": idx.build_compares,
        "index_build_device": build_dev,
        "inserts_per_s": m / walls["insert_serve_s"],
        "exact": bool(qok and gid_ok), "tombstone_ok": tomb_ok,
        "delta_build_compares": dbuild,
        "scan_correct": f"{scan_correct}/{len(reqs)}",
        "scan_width": scan_width, "scan_batches": scan_batches,
        "union_probe": {"compares": probe_compares, "bound": probe_bound,
                        "exact": probe_ok, "matched": int(want.sum())},
        "compact": {"merge_compares": cstats.merge_compares,
                    "merge_bound": merge_bound,
                    "rebuild_compares": cstats.rebuild_compares,
                    "rounds": cstats.merge_rounds, "sorted_ok": sorted_ok,
                    "post_probe_compares": post.stats.index_compares,
                    "post_exact": post_ok, "device": compact_dev},
        "walls": walls, "span_ms": spans, "launches": launches,
        "peak_mem_bytes": peak,
    }
    emit(out)
    require(build_ok, "the write table's index is not sorted")
    require(qok and gid_ok, "served answers diverged from the plaintext")
    require(tomb_ok, "the tombstoned rows were not excluded")
    require(scan_correct == len(reqs),
            f"scan over base ∪ delta answered {out['scan_correct']}")
    require(probe_ok, "union probe diverged from the from-scratch answer")
    require(probe_compares <= probe_bound,
            f"union probe {probe_compares} > bound {probe_bound}")
    require(not table.has_delta and sorted_ok and post_ok,
            "compaction left a delta, an unsorted index or a wrong answer")
    require(cstats.merge_compares <= merge_bound,
            f"merge {cstats.merge_compares} > bound {merge_bound}")
    require(cstats.merge_compares < cstats.rebuild_compares,
            "compaction cost a rebuild, not a merge")
    require(all(launches[k] > 0 for k in WRITE_KERNELS),
            f"a kernel never launched on the write path: {launches}")
    out["recorded_paper_shapes"] = pshapes        # for the paper phase
    return ks, table, out


def _span_ms(tracer) -> dict:
    """Total milliseconds by span name over a tracer's events."""
    spans: dict = {}
    for ev in tracer.chrome_trace()["traceEvents"]:
        spans[ev["name"]] = spans.get(ev["name"], 0.0) + ev["dur"] / 1e3
    return spans


def _device_summary(prof, wall_s: float, top: int = 6) -> dict:
    """Device busy time (union of kernel intervals), its share of the
    wall, and the top kernels by device time, from a torch.profiler run."""
    import torch
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict = {}                 # keyed as printed: 80 characters
    for e in dev:
        c, us = by_name.get(e.name[:80], (0, 0.0))
        by_name[e.name[:80]] = (c + 1, us + e.time_range.elapsed_us())
    busy_us, end = 0.0, None
    for e in sorted(dev, key=lambda e: e.time_range.start):
        lo, hi = e.time_range.start, e.time_range.end
        if end is None or lo >= end:
            busy_us += hi - lo
            end = hi
        elif hi > end:
            busy_us += hi - end
            end = hi
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return {"events": len(dev),
            "busy_s": busy_us / 1e6 if dev else None,
            "busy_share": busy_us / 1e6 / wall_s if dev else None,
            "ms_by_name": {name: {"count": c, "ms": us / 1e3}
                           for name, (c, us) in ranked}}


def record_gadget_shapes() -> tuple:
    """Record the shape of every call of the gadget Eval's wrapper until
    `stop()` (every module reaches the kernel through the attribute of
    `cmp_eval`).  Returns (shapes, stop): shapes maps (columns, width,
    rows, per-lane bounds, sel) to [calls, the first call's row offset]."""
    from repro_torch.kernels import cmp_eval as CK
    inner, shapes = CK.eval_coeff0_gadget, {}

    def recorded(uniq_c0, uniq_c1, row_offset, rows, sel, bounds_c0,
                 bounds_c1, *args, **kwargs):
        key = (*uniq_c1.shape[:2], rows, bounds_c1.dim() == 4,
               tuple(np.asarray(sel, np.int64).tolist()))
        shapes.setdefault(key, [0, row_offset])[0] += 1
        return inner(uniq_c0, uniq_c1, row_offset, rows, sel, bounds_c0,
                     bounds_c1, *args, **kwargs)

    def stop():
        CK.eval_coeff0_gadget = inner
    CK.eval_coeff0_gadget = recorded
    return shapes, stop


def check_gadget_shapes(ks, source, shapes: dict, seed: int, rate) -> dict:
    """The gadget Eval kernel against its plain version at every shape a
    path gave it (`record_gadget_shapes`), tolerance 0: the column stack
    and the bounds are rows of the path's own column `source` ([N, K, n])
    drawn by a seeded generator, at the path's first row offset and
    atom selection.  Each shape is timed by CUDA events beside its bound
    (one column tile per unique column the selection names); the plain
    version too at the most-called shape, which comes first."""
    import torch
    from repro_torch.core import sampling
    from repro_torch.kernels import cmp_eval as CK

    params = ks.params
    K, n, D = params.num_towers, params.n, params.gadget_digits_per_tower
    args = (ks.cek_rev, ks.ring.q_arr[:, 0], params.scale,
            params.profile.gadget_log_base)
    gen = sampling.make_generator(seed, ks.device)

    def draw(*shape):
        pick = torch.randint(0, source.c0.shape[0], (int(np.prod(shape)),),
                             generator=gen, device=ks.device)
        return (source.c0[pick].view(*shape, K, n),
                source.c1[pick].view(*shape, K, n))
    eq, out = True, []
    for (U, W, rows, per_lane, sel), (calls, off) in sorted(
            shapes.items(), key=lambda kv: -kv[1][0]):
        A = len(sel)
        u0, u1 = draw(U, W)
        b0, b1 = draw(A, rows) if per_lane else draw(A)

        def kernel():
            return CK.eval_coeff0_gadget(u0, u1, off, rows, sel, b0, b1,
                                         *args, cek_bytes=ks.cek_rev_bytes)

        def plain():
            return CK.eval_coeff0_gadget_plain(u0, u1, off, rows, sel, b0,
                                               b1, *args)
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        same = bool(torch.equal(got, want))
        eq &= same
        groups = [sel.count(u) for u in dict.fromkeys(sel)]
        bounds = [eval_bound(a, rows, K, n, D, per_lane, rate)
                  for a in groups]
        out.append({"columns": U, "width": W, "row_offset": off,
                    "rows": rows, "atoms": A, "per_lane": per_lane,
                    "launches_per_call": len(groups), "calls": calls,
                    "equal": same, "max_abs_err": max_abs_err(got, want),
                    "ms": time_cuda(kernel, 3),
                    **_bound(sum(b["bytes"] for b in bounds),
                             sum(b["ops"] for b in bounds),
                             INT8_TC_OPS_PER_S)})
        if len(out) == 1:
            out[0]["plain_ms"] = time_cuda(plain, 1)
        del u0, u1, b0, b1, got, want
    torch.cuda.empty_cache()
    return {"tolerance": 0, "equal": eq, "shapes": out}


def _lane_stride(t):
    """The batch stride in elements the paper Eval kernel reads t [B, K,
    n] with (`cmp_eval._rows`): 0 for one polynomial, K n for a copy."""
    if t is None:
        return None
    if t.shape[0] == 1:
        return 0
    if t.stride()[1:] != (t.shape[2], 1):
        return t.shape[1] * t.shape[2]
    return t.stride(0)


def record_paper_shapes() -> tuple:
    """Record every call of the paper Eval's wrapper until `stop()`
    (every module reaches the kernel through the attribute of
    `cmp_eval`): shapes maps (id of the caller's cek_rev, lanes, rows of
    b (0 in the column form), the lane strides of a0, a1, b0, b1) to
    [calls, cek_rev, qs, scale].  A call counts once the kernel has
    returned, under a lock: the serving loop's threads share the
    wrapper."""
    import threading

    from repro_torch.kernels import cmp_eval as CK
    inner, shapes, lock = CK.eval_coeff0_paper, {}, threading.Lock()

    def recorded(a0, a1, cek_rev, qs, scale, b0=None, b1=None):
        res = inner(a0, a1, cek_rev, qs, scale, b0, b1)
        key = (id(cek_rev), a1.shape[0], 0 if b1 is None else b1.shape[0],
               tuple(_lane_stride(t) for t in (a0, a1, b0, b1)))
        with lock:
            shapes.setdefault(key, [0, cek_rev, qs, scale])[0] += int(
                a1.shape[0] > 0)
        return res

    def stop():
        CK.eval_coeff0_paper = inner
    CK.eval_coeff0_paper = recorded
    return shapes, stop


def check_paper_shapes(sources: dict, shapes: dict, seed: int,
                       rate) -> dict:
    """The paper Eval kernel against its plain version at every shape a
    path gave it (`record_paper_shapes`), tolerance 0, on rows of the
    column of the tenant whose key made the call (`sources`: id of a
    KeySet's cek_rev -> (tenant, column [N, K, n])): a column-form pass
    of contiguous lanes on the column's own first rows, every other
    operand on rows drawn by a seeded generator and laid out at the
    recorded lane stride.  Each shape is timed by CUDA events beside its
    bound (`ms`, `ratio`), and split (`kernels/timing.py`) into the
    kernel's device time (`device_ms`, graph replay; `device_ratio`) and
    the wrapper's host time (`host_ms`); the empty launch's floor once
    (`floor`); the plain version too at the most-called shape, which
    comes first."""
    import torch
    from repro_torch.core import sampling
    from repro_torch.kernels import cmp_eval as CK
    from repro_torch.kernels import timing

    dev = next(iter(sources.values()))[1].c0.device
    gen = sampling.make_generator(seed, dev)
    eq, out = True, []
    for (key, B, b_rows, strides), (calls, cek, qs, scale) in sorted(
            shapes.items(), key=lambda kv: -kv[1][0]):
        tenant, col = sources[key]
        K, n = cek.shape
        kn, N = K * n, col.c0.shape[0]

        def laid(rows, s0, s1):
            if s0 == s1 == kn and rows <= N and b_rows == 0:
                return col.c0[:rows], col.c1[:rows]
            span = -(-((rows - 1) * max(s0, s1) + kn) // kn)
            pick = torch.randint(0, N, (span,), generator=gen,
                                 device=dev).to(col.c0.device)
            return tuple(c[pick].as_strided((rows, K, n), (s, n, 1))
                         for c, s in ((col.c0, s0), (col.c1, s1)))
        a0, a1 = laid(B, *strides[:2])
        b0, b1 = laid(b_rows, *strides[2:]) if b_rows else (None, None)

        def kernel():
            return CK.eval_coeff0_paper(a0, a1, cek, qs, scale, b0, b1)

        def plain():
            return CK.eval_coeff0_paper_plain(a0, a1, cek, qs, scale, b0, b1)
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        same = bool(torch.equal(got, want))
        eq &= same
        rec = {"tenant": tenant, "lanes": B, "b_rows": b_rows,
               "strides": list(strides), "calls": calls,
               "equal": same, "max_abs_err": max_abs_err(got, want),
               "ms": time_cuda(kernel, 3), **timing.split(kernel),
               **paper_bound(B, K, n, b_rows > 0, b_rows, rate)}
        rec["ratio"] = rec["ms"] / rec["bound_ms"]
        rec["device_ratio"] = rec["device_ms"] / rec["bound_ms"]
        out.append(rec)
        if len(out) == 1:
            out[0]["plain_ms"] = time_cuda(plain, 1)
        del a0, a1, b0, b1, got, want
    torch.cuda.empty_cache()
    floor = timing.launch_floor(dev)
    # host_ms is the wrapper's own time only while the card stayed busy
    # behind every batch of calls
    require(floor["saturated"] and all(r["saturated"] for r in out),
            "paper shapes: the card went idle under a host-time batch")
    return {"tolerance": 0, "equal": eq, "shapes": out, "floor": floor}


def phase_paper(ks, table, write, rate) -> dict:
    """The paper Eval kernel against its plain version at every shape the
    write phase gave it, on the write table's column: the shapes listed
    below and every shape the write path recorded (`record_paper_shapes`,
    its calls reconciled with the path's launches, each shape split into
    device and host time); timed at the scan tile and at the sort and
    merge stage shapes.  Then its edges: lane counts that are multiples
    of no cluster size (1, 3, 5, 127), one b for every lane, the column
    form at a row offset, and n = 16,384 (the paper-ckks ring in paper
    mode) on seeded residues, split and wide."""
    import torch
    from repro_torch.core import sampling
    from repro_torch.core.compare import next_pow2
    from repro_torch.core.params import make_params
    from repro_torch.kernels import cmp_eval as CK
    from repro_torch.kernels import ops as KO

    params = ks.params
    K, n = params.num_towers, params.n
    qs = ks.ring.q_arr[:, 0]
    col = table.columns["value"]
    W = write["scan_width"]
    gen = sampling.make_generator(SEED + 13, ks.device)
    args = (ks.cek_rev, qs, params.scale)
    tiles = sorted({min(KO.lane_tile(W, b["scan_compares"] // W),
                        table.n_padded) for b in write["scan_batches"]})
    delta_rows = W - table.n_padded if W > table.n_padded else 2048
    # a merge stage compares L = next_pow2(base rows) pairs, a sort stage
    # L / 2: the first half of the merge lanes
    merge_pairs = next_pow2(write["rows_base"])
    pairs = merge_pairs // 2
    pick = torch.randint(0, table.n_rows, (2, merge_pairs), generator=gen,
                         device=ks.device)
    mlo = (col.c0[pick[0]], col.c1[pick[0]])
    mhi = (col.c0[pick[1]], col.c1[pick[1]])
    lo, hi = (mlo[0][:pairs], mlo[1][:pairs]), (mhi[0][:pairs], mhi[1][:pairs])
    probe = torch.randint(0, table.n_rows, (2, 8), generator=gen,
                          device=ks.device)
    cases = []                       # (name, a0, a1, b0, b1)
    for T in tiles:
        for off in (0, table.n_padded - T):
            cases.append((f"column {T}@{off}", col.c0[off:off + T],
                          col.c1[off:off + T], None, None))
    cases.append(("column delta", col.c0[-delta_rows:],
                  col.c1[-delta_rows:], None, None))
    cases.append(("column full", col.c0, col.c1, None, None))
    for A in (8, 10):
        b = sampling.uniform_poly(params, gen, (2, A))
        cases.append((f"bounds {A}", b[0], b[1], None, None))
    cases.append(("lanes sort", *lo, *hi))
    cases.append(("lanes merge", *mlo, *mhi))
    for B in (2, 8):
        cases.append((f"lanes probe {B}", col.c0[probe[0, :B]],
                      col.c1[probe[0, :B]], col.c0[probe[1, :B]],
                      col.c1[probe[1, :B]]))
    cases.append(("lanes one bound", *lo, lo[0][:1], lo[1][:1]))
    for B in (1, 3, 5, 127):
        cases.append((f"lanes edge {B}", *(x[:B] for x in lo),
                       *(x[:B] for x in hi)))
    cases.append(("lanes edge 127 one bound", *(x[:127] for x in lo),
                  hi[0][:1], hi[1][:1]))
    cases.append(("column edge 127@7", col.c0[7:134], col.c1[7:134], None,
                  None))
    eq, errs = True, {}
    for name, a0, a1, b0, b1 in cases:
        got = CK.eval_coeff0_paper(a0, a1, *args, b0, b1)
        want = CK.eval_coeff0_paper_plain(a0, a1, *args, b0, b1)
        torch.cuda.synchronize()
        eq &= torch.equal(got, want)
        errs[name] = max_abs_err(got, want)
    # n = 16,384: the kernel's largest instance, split and wide
    big = make_params("paper-ckks", mode="paper")
    bqs = torch.tensor(big.qs, dtype=torch.int64, device=ks.device)

    def residues(*shape):
        u = torch.randint(0, 1 << 62, shape + (big.num_towers, big.n),
                          generator=gen, device=ks.device)
        return u % bqs[:, None]
    bargs = (residues(), bqs, big.scale)
    wide = CK.paper_wide_lanes() + 5
    x0, x1, y0, y1 = (residues(wide) for _ in range(4))
    for B in (1, 5, 127, wide):
        for name, b0, b1, off in (("lanes", y0[:B], y1[:B], 0),
                                  ("one bound", y0[:1], y1[:1], 0),
                                  ("column", None, None, 3)):
            if off + B > wide:
                off = 0
            a0, a1 = x0[off:off + B], x1[off:off + B]
            got = CK.eval_coeff0_paper(a0, a1, *bargs, b0, b1)
            want = CK.eval_coeff0_paper_plain(a0, a1, *bargs, b0, b1)
            torch.cuda.synchronize()
            eq &= torch.equal(got, want)
            errs[f"n16384 {name} {B}@{off}"] = max_abs_err(got, want)
    del x0, x1, y0, y1, got, want
    # every shape the write path launched, its calls against its launches
    recorded = check_paper_shapes(
        {id(ks.cek_rev): ("write", col)}, write["recorded_paper_shapes"],
        SEED + 14, rate)
    reconciled = (sum(r["calls"] for r in recorded["shapes"])
                  == write["launches"]["eval_coeff0_paper"])
    timed = {
        "column": [{"rows": T,
                    "ms": time_cuda(lambda: CK.eval_coeff0_paper(
                        col.c0[:T], col.c1[:T], *args), 10),
                    "plain_ms": time_cuda(
                        lambda: CK.eval_coeff0_paper_plain(
                            col.c0[:T], col.c1[:T], *args), 1),
                    **paper_bound(T, K, n, False, 0, rate)}
                   for T in tiles],
        "lanes": {"pairs": pairs,
                  "ms": time_cuda(lambda: CK.eval_coeff0_paper(
                      *lo, *args, *hi), 10),
                  "plain_ms": time_cuda(lambda: CK.eval_coeff0_paper_plain(
                      *lo, *args, *hi), 1),
                  **paper_bound(pairs, K, n, True, pairs, rate)},
        "lanes_merge": {
            "pairs": merge_pairs,
            "ms": time_cuda(lambda: CK.eval_coeff0_paper(
                *mlo, *args, *mhi), 10),
            "plain_ms": time_cuda(lambda: CK.eval_coeff0_paper_plain(
                *mlo, *args, *mhi), 1),
            **paper_bound(merge_pairs, K, n, True, merge_pairs, rate)},
    }
    del lo, hi, mlo, mhi, cases
    torch.cuda.empty_cache()
    out = {"phase": "paper", "tolerance": 0, "equal": eq,
           "max_abs_err": max(errs.values()), "cases": errs, **timed,
           "write_shapes": recorded, "launches_reconciled": reconciled}
    emit(out)
    require(eq, f"paper Eval kernel != plain (|err| {errs})")
    require(recorded["equal"], "paper Eval kernel != plain at a write path "
            f"shape: {recorded['shapes']}")
    require(reconciled, f"write launches {write['launches']} != the "
            "recorded calls")
    return out


def _sharded_query(ks, vals):
    """The sharded benchmark's query: a Range over the 30th-70th
    percentile with TopK SHARD_TOPK (benchmarks/db_engine.py run_sharded),
    and its truth (mask, top values)."""
    from repro_torch.core import encrypt as E
    from repro_torch.db import plan as P
    lo, hi = (int(np.percentile(vals, 30)), int(np.percentile(vals, 70)))
    q = P.Query(where=P.Range("value", E.encrypt(ks, lo, SEED + 31),
                              E.encrypt(ks, hi, SEED + 32)),
                top_k=P.TopK("value", SHARD_TOPK))
    mask = (vals >= lo) & (vals <= hi)
    return q, mask, sorted(vals[mask].tolist(), reverse=True)[:SHARD_TOPK]


def _shard_traffic(ks, st, vals, reqs, q_top, *, trace=False) -> dict:
    """The shard phase's traffic over the sharded table `st` (the serve
    keys' hg38 rows in SHARDS logical shards): the 8 requests and the
    sharded benchmark's Range/TopK through a ShardedQueryServer, a
    ShardedIndex build and an Eq probe, SHARD_INSERT inserts with a Range,
    the Range by scan over base ∪ delta, compaction, the Range by index
    and by scan.  Walls by host clock after a synchronize; with `trace`
    the served batches and the index build under torch.profiler.
    Returns what ran (the server, index, results, compaction stats), the
    walls, and `answers`: every answer as host arrays."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import db
    from repro_torch.core import encrypt as E
    from repro_torch.db import plan as P

    walls, devs = {}, {}

    def timed(name, fn):
        if not trace or name not in ("serve_s", "index_build_s"):
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0
            return out
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0
        devs[name] = _device_summary(prof, walls[name])
        return out

    server = db.ShardedQueryServer(ks, st, batch=BATCH)
    ids = [server.submit(q) for q, _ in reqs] + [server.submit(q_top)]
    res = timed("serve_s", server.run)
    idx = timed("index_build_s",
                lambda: db.ShardedIndex.build(ks, st, "value"))
    target = int(vals[len(vals) // 3])
    probe = timed("eq_probe_s", lambda: db.execute(
        ks, st, P.Eq("value", E.encrypt(ks, target, SEED + 33)),
        indexes={"value": idx}))

    # ---- writes: insert, Range over base ∪ delta, compact, Range ---------
    rng = np.random.default_rng(SEED + 34)
    ins_vals = rng.choice(vals, SHARD_INSERT)
    writer = db.ShardedQueryServer(ks, st, indexes={"value": idx},
                                   batch=BATCH)
    lo, hi = (int(v) for v in np.sort(rng.choice(vals, 2, replace=False)))
    rq = P.Range("value", E.encrypt(ks, lo, SEED + 35),
                 E.encrypt(ks, hi, SEED + 36))

    def insert_range():
        ins = writer.submit_insert({"value": ins_vals}, SEED + 37)
        qid = writer.submit(rq)
        return ins, qid, writer.run()
    ins, qid, wres = timed("insert_range_s", insert_range)
    delta_slots = st.delta_block
    scan = timed("union_scan_s", lambda: db.execute(ks, st, rq))
    cstats = timed("compact_s", writer.compact)
    after = db.execute(ks, st, rq, indexes=writer.indexes)
    after_scan = db.execute(ks, st, rq)
    all_vals = np.concatenate([vals, ins_vals])
    return {
        "server": server, "res": res, "ids": ids, "index": idx,
        "probe": probe, "target": target, "cstats": cstats,
        "delta_slots": delta_slots, "walls": walls, "devices": devs,
        "write_want": (all_vals >= lo) & (all_vals <= hi),
        "answers": {
            "served": [res[i].row_ids for i in ids],
            "top_mask": res[ids[-1]].mask, "probe_mask": probe.mask,
            "insert_ids": wres[ins].row_ids,
            "write_masks": [wres[qid].mask, scan.mask, after.mask,
                            after_scan.mask]}}


def _same_answers(a: dict, b: dict) -> bool:
    """Two `_shard_traffic` answer sets equal, array for array."""
    def arrays(answers):
        return [x for v in answers.values()
                for x in (v if isinstance(v, list) else [v])]
    return all(np.array_equal(x, y) for x, y in zip(arrays(a), arrays(b)))


def record_raw(module, name: str) -> tuple:
    """Record the raw values every call of `module.name` returns (a host
    array) until `stop()`: the sharded engine's fused-scan and pair-grid
    values, to hold one placement's against another's byte for byte.
    Returns (records, stop).  A call only keeps its array (no copy, no
    hash: the walls around it measure the engine alone); stop() turns
    each record into (shape, sha256 of the bytes) and returns the
    seconds that took."""
    inner, records = getattr(module, name), []

    def recorded(*args, **kwargs):
        vals = inner(*args, **kwargs)
        records.append(vals)
        return vals

    def stop():
        setattr(module, name, inner)
        t0 = time.perf_counter()
        for i, vals in enumerate(records):
            records[i] = [list(vals.shape), hashlib.sha256(
                np.ascontiguousarray(vals).tobytes()).hexdigest()]
        return time.perf_counter() - t0
    setattr(module, name, recorded)
    return records, stop


def phase_shard(ks, vals, rate) -> tuple:
    """The sharded read and write path over the serve keys' hg38 table
    (re-encrypted under the serve phase's seed: the same rows), unplaced
    (`ShardSpec.create(SHARDS, use_mesh=False)`: every shard on the
    card), with every launch count zeroed just before it, the served
    batches and the index build under torch.profiler; then one
    shard-stacked scan tile against its plain version.  Returns the
    phase's record and the baseline the placement phase holds its
    placed runs to (the inputs, the answers, the raw values)."""
    import torch

    from repro_torch import db
    from repro_torch.core import ring as R
    from repro_torch.core.compare import next_pow2
    from repro_torch.db import plan as P
    from repro_torch.db.executor import dedup_atom_columns, stack_atom_bounds
    from repro_torch.db.query_serve import QueryServer
    from repro_torch.db.shard import executor as SX
    from repro_torch.db.table import Table
    from repro_torch.kernels import _build
    from repro_torch.kernels import cmp_eval as CK
    from repro_torch.kernels import ops as KO

    table = Table.from_arrays(ks, "hg38", {"value": vals}, SEED + 1)
    reqs = _requests(ks, vals, np.random.default_rng(SEED))
    q_top, top_mask, top_want = _sharded_query(ks, vals)
    # the unsharded answers, and S = 1's counters for the ratio check
    flat = QueryServer(ks, table, batch=BATCH)
    fids = [flat.submit(q) for q, _ in reqs] + [flat.submit(q_top)]
    flat_res = flat.run()
    one = db.ShardedTable.from_table(ks, table, spec=db.ShardSpec.create(1))
    one_stats = db.execute(ks, one, q_top).stats
    del one, flat
    gc.collect()
    torch.cuda.empty_cache()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    shapes, stop_recording = record_gadget_shapes()
    raw, stop_raw = record_raw(SX, "sharded_fused_eval")
    t0 = time.perf_counter()
    st = db.ShardedTable.from_table(
        ks, table, spec=db.ShardSpec.create(SHARDS, use_mesh=False))
    torch.cuda.synchronize()
    partition_s = time.perf_counter() - t0
    n_sp = st.n_padded_per_shard
    del table
    t = _shard_traffic(ks, st, vals, reqs, q_top, trace=True)
    walls = {"partition_s": partition_s, **t["walls"]}
    res, ids, probe, idx = t["res"], t["ids"], t["probe"], t["index"]
    correct = 0
    for qid, fid, (_, truth) in zip(ids, fids, reqs):
        want = np.nonzero(truth(vals))[0]
        correct += int(np.array_equal(res[qid].row_ids, want)
                       and np.array_equal(flat_res[fid].row_ids, want))
    top = res[ids[-1]]
    top_ok = bool(np.array_equal(top.mask, top_mask)
                  and vals[top.row_ids].tolist() == top_want
                  and vals[flat_res[fids[-1]].row_ids].tolist() == top_want)
    ratio = (top.stats.per_shard_scan_compares
             / one_stats.per_shard_scan_compares)
    kp, sp = next_pow2(SHARD_TOPK), next_pow2(SHARDS)
    merge_bound = (sp - 1) * (kp + (kp // 2) * max(1, kp.bit_length() - 1))
    probe_ok = bool(np.array_equal(probe.mask, vals == t["target"]))
    answers, want = t["answers"], t["write_want"]
    write_ok = bool(np.array_equal(answers["insert_ids"],
                                   len(vals) + np.arange(SHARD_INSERT))
                    and all(np.array_equal(m, want)
                            for m in answers["write_masks"][:2]))
    compact_ok = bool(not st.has_delta
                      and all(np.array_equal(m, want)
                              for m in answers["write_masks"][2:]))
    cstats = t["cstats"]
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    stop_recording()
    walls["raw_hash_s"] = stop_raw()
    peak = torch.cuda.max_memory_allocated()

    # ---- one shard-stacked scan tile against its plain version -----------
    params = ks.params
    K, n, D = params.num_towers, params.n, params.gadget_digits_per_tower
    atoms = [a for q, _ in reqs[:BATCH] for i in range(
        P.compile_plan(q).num_leaves) for a in P.compile_plan(q).scan_atoms(i)]
    A, W = len(atoms), st.shard_scan_width
    T = KO.lane_tile(W, SHARDS * A)
    uniq, sel = dedup_atom_columns(st, atoms, st.scan_stack)
    uniq = type(uniq)(uniq.c0.full(), uniq.c1.full())   # the one slab
    bounds = stack_atom_bounds(atoms)
    lo_row = W - T
    got = KO.slab_scan_values(ks, uniq, sel, bounds, lo_row, T)
    qs = ks.ring.q_arr[:, 0]

    tile_want = torch.stack([R.crt_centered(
        params, CK.eval_coeff0_gadget_plain(
            uniq.c0[s], uniq.c1[s], lo_row, T, sel, bounds.c0[:, 0],
            bounds.c1[:, 0], ks.cek_rev, qs, params.scale,
            params.profile.gadget_log_base)) for s in range(SHARDS)])
    torch.cuda.synchronize()
    tile_eq = bool(torch.equal(got, tile_want))
    tile_err = max_abs_err(got, tile_want)

    def kernel_tile():
        for s in range(SHARDS):
            CK.eval_coeff0_gadget(
                uniq.c0[s], uniq.c1[s], lo_row, T, sel, bounds.c0[:, 0],
                bounds.c1[:, 0], ks.cek_rev, qs, params.scale,
                params.profile.gadget_log_base, cek_bytes=ks.cek_rev_bytes)

    def plain_kernels():
        for s in range(SHARDS):
            CK.eval_coeff0_gadget_plain(
                uniq.c0[s], uniq.c1[s], lo_row, T, sel, bounds.c0[:, 0],
                bounds.c1[:, 0], ks.cek_rev, qs, params.scale,
                params.profile.gadget_log_base)
    one_b = eval_bound(A, T, K, n, D, False, rate)
    tile = {"shards": SHARDS, "atoms": A, "rows": T,
            "launches": SHARDS * len(set(sel.tolist())),
            "equal": tile_eq, "max_abs_err": tile_err,
            "ms": time_cuda(kernel_tile, 5),
            "plain_ms": time_cuda(plain_kernels, 1),
            **_bound(SHARDS * one_b["bytes"], SHARDS * one_b["ops"],
                     INT8_TC_OPS_PER_S)}
    del uniq, bounds, got, tile_want
    stack = st.columns["value"]                      # [S, N_sp, K, n]
    rows = type(stack)(stack.c0.full().reshape(-1, K, n),
                       stack.c1.full().reshape(-1, K, n))
    path_shapes = check_gadget_shapes(ks, rows, shapes, SEED + 45, rate)
    del stack, rows
    out = {
        "phase": "shard", "profile": PROFILE, "mode": "gadget",
        "shards": SHARDS, "rows": int(len(vals)),
        "n_padded_per_shard": n_sp,
        "requests": len(ids), "batch": BATCH,
        "correct": f"{correct}/{len(reqs)}", "topk_ok": top_ok,
        "per_shard_scan_compares": top.stats.per_shard_scan_compares,
        "per_shard_scan_compares_s1": one_stats.per_shard_scan_compares,
        "scan_ratio": ratio, "merge_compares": top.stats.merge_compares,
        "merge_bound": merge_bound,
        "batches": [{"queries": b.queries, "eval_calls": b.eval_calls,
                     "scan_compares": b.scan_compares,
                     "merge_compares": b.merge_compares,
                     "wall_s": b.wall_s} for b in t["server"].batch_log],
        "index_build_compares": idx.build_compares,
        "eq_probe": {"exact": probe_ok,
                     "compares": probe.stats.index_compares,
                     "matched": int((vals == t["target"]).sum())},
        "insert": {"rows": SHARD_INSERT, "delta_slots": t["delta_slots"],
                   "exact": write_ok},
        "compact": {"merge_compares": cstats.merge_compares,
                    "rebuild_compares": cstats.rebuild_compares,
                    "rounds": cstats.merge_rounds, "exact": compact_ok},
        "walls": walls, "serve_device": t["devices"]["serve_s"],
        "index_build_device": t["devices"]["index_build_s"],
        "launches": launches, "peak_mem_bytes": peak, "scan_tile": tile,
        "gadget_shapes": path_shapes, "mesh_devices": st.spec.mesh_devices,
        "raw_scans": raw,
    }
    emit(out)
    require(correct == len(reqs), f"sharded server answered {out['correct']}")
    require(top_ok, "the sharded top-k differs from the truth")
    require(abs(ratio - 1 / SHARDS) < 1e-12,
            f"per-shard scan ratio {ratio} != 1/{SHARDS}")
    require(top.stats.merge_compares <= merge_bound,
            f"merge {top.stats.merge_compares} > k·S bound {merge_bound}")
    require(probe_ok, "the sharded index probe differs from the truth")
    require(write_ok, "the sharded insert or the union read diverged")
    require(compact_ok, "sharded compaction left a delta or a wrong answer")
    require(tile_eq, f"sharded scan tile != plain (max |err| {tile_err})")
    require(path_shapes["equal"], "the gadget Eval != plain at a shard "
            f"path shape: {path_shapes['shapes']}")
    require(all(launches[k] > 0 for k in SHARD_KERNELS),
            f"a kernel never launched on the shard path: {launches}")
    return out, {"reqs": reqs, "q_top": q_top, "answers": answers,
                 "raw": raw, "walls": walls, "peak_mem_bytes": peak,
                 "launches": launches}


def phase_join(ks, wks, vals, rate) -> tuple:
    """The join benchmark's traffic, with every launch count zeroed just
    before it: sort-merge at full hg38 (gadget, serve keys), then nested
    loops on the JOIN_CUT rows in gadget mode (two joins sharing one grid
    through a QueryServer batch, and a [SHARDS x SHARDS]-shard join) and
    in paper mode (the write keys `wks`); between them the sort-merge
    join again on both sides split into SHARDS unplaced shards (each
    side's ShardedIndex built by the join), pairs equal to the
    unsharded join's, wall and peak recorded.  The sort-merge join and
    the shared grid run under torch.profiler.  Returns the cut tables
    for the layout checks."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import db
    from repro_torch.db import join as J
    from repro_torch.db import plan as P
    from repro_torch.db.index import SortedIndex
    from repro_torch.db.query_serve import QueryServer
    from repro_torch.db.shard import join as SJ
    from repro_torch.db.table import Table
    from repro_torch.kernels import _build

    def sync_s(t0):
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    n_l = len(vals)
    n_r = n_l // 2
    buckets = max(8, n_l // 8)
    lk, rk = vals % buckets, vals[n_l - n_r:] % buckets
    join = P.Join(None, None, on="k")
    walls = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    shapes, stop_recording = record_gadget_shapes()
    pshapes, pstop = record_paper_shapes()
    t0 = time.perf_counter()
    left = Table.from_arrays(ks, "hg38_l", {"k": lk}, SEED + 40)
    right = Table.from_arrays(ks, "hg38_r", {"k": rk}, SEED + 41)
    walls["encrypt_s"] = sync_s(t0)
    t0 = time.perf_counter()
    li = SortedIndex.build(ks, left, "k")
    walls["left_index_build_s"] = sync_s(t0)
    t0 = time.perf_counter()
    ri = SortedIndex.build(ks, right, "k")
    walls["right_index_build_s"] = sync_s(t0)
    server = QueryServer(ks, left, indexes={"k": li}, batch=BATCH)
    jid = server.submit_join(join, right, right_indexes={"k": ri})
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sm = server.run()[jid]
        walls["sort_merge_s"] = sync_s(t0)
    sm_dev = _device_summary(prof, walls["sort_merge_s"])
    del prof
    want = np.argwhere(lk[:, None] == rk[None, :])
    sm_ok = bool(np.array_equal(sm.pairs, want))
    cl, cr = JOIN_CUT
    in_cut = (sm.pairs[:, 0] < cl) & (sm.pairs[:, 1] < cr)
    sm_cut = sm.pairs[in_cut]
    sm_peak = torch.cuda.max_memory_allocated()
    index_build_compares = [li.build_compares, ri.build_compares]

    # ---- nested loops on the cut: gadget (shared grid, shards), paper ----
    lcut = Table.from_ciphertexts("hg38_l_cut", {"k": left.gather(
        "k", np.arange(cl))}, cl)
    rcut = Table.from_ciphertexts("hg38_r_cut", {"k": right.gather(
        "k", np.arange(cr))}, cr)

    # ---- sort-merge again over SHARDS shards of each side ----------------
    unplaced = db.ShardSpec.create(SHARDS, use_mesh=False)
    sl = db.ShardedTable.from_table(ks, left, spec=unplaced)
    sr = db.ShardedTable.from_table(ks, right, spec=unplaced)
    del left, right, li, ri, server
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ssm = db.execute_join(ks, sl, sr, join, strategy="sort_merge")
    walls["sort_merge_sharded_s"] = sync_s(t0)
    ssm_peak = torch.cuda.max_memory_allocated()
    ssm_ok = bool(np.array_equal(ssm.pairs, sm.pairs)
                  and np.array_equal(ssm.pairs, want))
    del sl, sr
    gc.collect()
    torch.cuda.empty_cache()
    want_cut = np.argwhere(lk[:cl, None] == rk[None, :cr])
    nested = QueryServer(ks, lcut, batch=BATCH)
    j1 = nested.submit_join(join, rcut, strategy="nested")
    j2 = nested.submit_join(join, rcut, strategy="nested")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        nres = nested.run()
        walls["nested_gadget_s"] = sync_s(t0)
    nested_dev = _device_summary(prof, walls["nested_gadget_s"])
    del prof
    b = nested.batch_log[0]
    nested_ok = bool(np.array_equal(nres[j1].pairs, want_cut)
                     and np.array_equal(nres[j2].pairs, want_cut)
                     and np.array_equal(sm_cut, want_cut))
    tiles = cl // J._grid_tile(J._resolve_block_pairs(None), cl, cr)
    grid_raw, stop_raw = record_raw(SJ, "sharded_pair_eval")
    t0 = time.perf_counter()
    unplaced = db.ShardSpec.create(SHARDS, use_mesh=False)
    sl = db.ShardedTable.from_table(ks, lcut, spec=unplaced)
    sr = db.ShardedTable.from_table(ks, rcut, spec=unplaced)
    sharded = db.execute_join(ks, sl, sr, join, strategy="nested")
    walls["nested_sharded_s"] = sync_s(t0)
    walls["nested_sharded_hash_s"] = stop_raw()
    del sl, sr
    sharded_ok = bool(np.array_equal(sharded.pairs, nres[j1].pairs))
    t0 = time.perf_counter()
    pl = Table.from_arrays(wks, "hg38_l_cut", {"k": lk[:cl]}, SEED + 42)
    pr = Table.from_arrays(wks, "hg38_r_cut", {"k": rk[:cr]}, SEED + 43)
    walls["encrypt_paper_cut_s"] = sync_s(t0)
    t0 = time.perf_counter()
    paper = db.execute_join(wks, pl, pr, join, strategy="nested")
    walls["nested_paper_s"] = sync_s(t0)
    paper_ok = bool(np.array_equal(paper.pairs, want_cut))
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    stop_recording()
    pstop()
    peak = max(sm_peak, ssm_peak, torch.cuda.max_memory_allocated())
    path_shapes = check_gadget_shapes(ks, lcut.column("k"), shapes,
                                      SEED + 46, rate)
    paper_shapes = check_paper_shapes(
        {id(wks.cek_rev): ("join", pl.column("k"))}, pshapes, SEED + 47,
        rate)
    paper_reconciled = (sum(s["calls"] for s in paper_shapes["shapes"])
                        == launches["eval_coeff0_paper"])

    def stats(r):
        s = r.stats
        return {"eval_calls": s.eval_calls, "pair_compares": s.pair_compares,
                "merge_compares": s.merge_compares,
                "adjacency_compares": s.adjacency_compares,
                "verify_compares": s.verify_compares,
                "build_compares": s.build_compares,
                "join_compares": s.join_compares, "pairs": len(r)}
    out = {
        "phase": "join", "profile": PROFILE, "buckets": buckets,
        "rows": [n_l, n_r], "cut": list(JOIN_CUT),
        "sort_merge": {"exact": sm_ok, **stats(sm),
                       "index_build_compares": index_build_compares,
                       "peak_mem_bytes": sm_peak, "device": sm_dev},
        "sort_merge_sharded": {"exact": ssm_ok, **stats(ssm),
                               "shards": list(ssm.stats.shards),
                               "peak_mem_bytes": ssm_peak},
        "nested_gadget": {"exact": nested_ok, **stats(nres[j1]),
                          "batch_joins": b.joins,
                          "grid_evals": b.grid_evals,
                          "grid_pair_compares": b.pair_compares,
                          "device": nested_dev},
        "nested_sharded": {"exact": sharded_ok, **stats(sharded),
                           "shards": list(sharded.stats.shards),
                           "raw_grid": grid_raw},
        "nested_paper": {"exact": paper_ok, **stats(paper)},
        "walls": walls, "launches": launches, "peak_mem_bytes": peak,
        "gadget_shapes": path_shapes, "paper_shapes": paper_shapes,
        "paper_launches_reconciled": paper_reconciled,
    }
    emit(out)
    require(sm_ok, "the sort-merge join's pairs differ from the plaintext")
    require(ssm_ok, f"the [{SHARDS}x{SHARDS}]-shard sort-merge join's pairs "
            "differ from the unsharded join's or the plaintext")
    require(nested_ok, "the nested cut's pairs differ (plaintext/sort-merge)")
    require(b.grid_evals == tiles,
            f"two joins launched {b.grid_evals} grid tiles, not {tiles}")
    require(sharded_ok, "the sharded nested join's pairs differ")
    require(paper_ok, "the paper-mode nested cut's pairs differ")
    require(path_shapes["equal"], "the gadget Eval != plain at a join path "
            f"shape: {path_shapes['shapes']}")
    require(paper_shapes["equal"], "the paper Eval != plain at a join path "
            f"shape: {paper_shapes['shapes']}")
    require(paper_reconciled, f"paper Eval launches {launches} != the "
            "recorded calls")
    require(all(launches[k] > 0 for k in JOIN_KERNELS),
            f"a kernel never launched on the join path: {launches}")
    return lcut, rcut, pl, pr, out


def phase_layouts(ks, wks, lcut, rcut, pl, pr, rate) -> dict:
    """The join's kernel layouts against their plain versions on the cut
    tables: the gadget pair-grid tile (the negated right column against
    T negated left atoms), a tile whose digits are all those of q - 1,
    and the paper Eval's column form over each side."""
    import torch
    from repro_torch.core import ring as R
    from repro_torch.core import sampling
    from repro_torch.db import join as J
    from repro_torch.kernels import cmp_eval as CK
    from repro_torch.kernels import ops as KO

    params, ring = ks.params, ks.ring
    K, n, D = params.num_towers, params.n, params.gadget_digits_per_tower
    lb, qs = params.profile.gadget_log_base, ring.q_arr[:, 0]
    cl, cr = JOIN_CUT
    T = J._grid_tile(J._resolve_block_pairs(None), cl, cr)
    lct, rct = lcut.column("k"), rcut.column("k")
    grid = KO.PairGrid(ks, lct, rct)
    lo = cl - T
    b0, b1 = R.neg(ring, lct.c0[lo:]), R.neg(ring, lct.c1[lo:])
    zeros = [0] * T

    def ev(kernel, uniq, sel, bnd0, bnd1, rows):
        args = (uniq.c0, uniq.c1, 0, rows, sel, bnd0, bnd1, ks.cek_rev, qs,
                params.scale, lb)
        if kernel:
            return CK.eval_coeff0_gadget(*args, cek_bytes=ks.cek_rev_bytes)
        return CK.eval_coeff0_gadget_plain(*args)
    neg_r = grid.neg_right
    cases = {}
    got = ev(True, neg_r, zeros, b0, b1, cr)
    want = ev(False, neg_r, zeros, b0, b1, cr)
    cases["pair tile"] = (got, want)
    # d = l - r = q - 1 on every coefficient: right rows all c, left c - 1
    gen = sampling.make_generator(SEED + 44, ks.device)
    c = sampling.uniform_poly(params, gen, (2, 1))
    rc0, rc1 = c[0].expand(cr, K, n).contiguous(), c[1].expand(
        cr, K, n).contiguous()
    q = ring.q_arr
    top = type(lct)(R.neg(ring, rc0)[None], R.neg(ring, rc1)[None])
    t0_ = R.neg(ring, ((c[0] - 1) % q).expand(T, K, n).contiguous())
    t1_ = R.neg(ring, ((c[1] - 1) % q).expand(T, K, n).contiguous())
    cases["q - 1 digits"] = (ev(True, top, zeros, t0_, t1_, cr),
                             ev(False, top, zeros, t0_, t1_, cr))
    pargs = (wks.cek_rev, wks.ring.q_arr[:, 0], wks.params.scale)
    for name, ct in (("paper column left", pl.column("k")),
                     ("paper column right", pr.column("k"))):
        cases[name] = (CK.eval_coeff0_paper(ct.c0, ct.c1, *pargs),
                       CK.eval_coeff0_paper_plain(ct.c0, ct.c1, *pargs))
    eq, errs = True, {}
    torch.cuda.synchronize()
    for name, (g, w) in cases.items():
        eq &= torch.equal(g, w)
        errs[name] = max_abs_err(g, w)
    grid_eq = bool(torch.equal(grid.tile(lo, T),
                               R.crt_centered(params, want)))
    del cases, got
    pl_ct, pr_ct = pl.column("k"), pr.column("k")
    out = {
        "phase": "layouts", "tolerance": 0, "equal": bool(eq and grid_eq),
        "max_abs_err": max(errs.values()), "cases": errs,
        "pair_tile": {"layout": "negated right column x negated left atoms",
                      "atoms": T, "rows": cr,
                      "ms": time_cuda(lambda: ev(True, neg_r, zeros, b0, b1,
                                                 cr), 20),
                      "plain_ms": time_cuda(lambda: ev(False, neg_r, zeros,
                                                       b0, b1, cr), 1),
                      "tile_ms": time_cuda(lambda: grid.tile(lo, T), 20),
                      **eval_bound(T, cr, K, n, D, False, rate)},
        "paper_column": [{"rows": int(ct.c0.shape[0]),
                          "ms": time_cuda(lambda: CK.eval_coeff0_paper(
                              ct.c0, ct.c1, *pargs), 10),
                          "plain_ms": time_cuda(
                              lambda: CK.eval_coeff0_paper_plain(
                                  ct.c0, ct.c1, *pargs), 1),
                          **paper_bound(int(ct.c0.shape[0]), K, n, False, 0,
                                        rate)}
                         for ct in (pl_ct, pr_ct)],
    }
    emit(out)
    require(eq and grid_eq, f"a join layout != plain (|err| {errs})")
    return out


# ---------------------------------------------------------------------------
# the serving loop under its benchmark's traffic (benchmarks/serve_loop.py)
# ---------------------------------------------------------------------------

def phase_placement(ks, wks, vals, lcut, rcut, pl, pr, base, join,
                    rate) -> dict:
    """The shard phase's traffic on placed tables, on two shard meshes:
    (a) `ShardSpec.create(SHARDS)`, the visible cards (on one card d = 1,
    which the record says), and (b) SHARDS explicit positions over the
    cards (`[cuda:0] * 4` on one card: d = 4, each slab's launches on its
    position's card).  Each mesh re-encrypts the serve keys' hg38 table
    under the shard phase's seed, places it and runs `_shard_traffic`,
    then the [SHARDS x SHARDS] nested and sort-merge joins on the join
    phase's cut (the sort-merge's wall and each card's peak recorded)
    and one paper-mode scan under the write keys `wks` over the paper cut
    `pl`, with every launch count zeroed just before it.  Every raw
    fused-scan and pair-grid value, answer and pair equals the unplaced
    runs' (`base` from the shard phase, `join`'s grid, this phase's
    unplaced paper scan) and the plaintext; every gadget and paper Eval
    shape the placed path gave the kernels equals its plain version,
    launches reconciled; walls and each card's peak memory."""
    import torch

    from repro_torch import db
    from repro_torch.core import encrypt as E
    from repro_torch.db import plan as P
    from repro_torch.db.shard import executor as SX
    from repro_torch.db.shard import join as SJ
    from repro_torch.db.table import Table
    from repro_torch.kernels import _build

    def sync_s(t0):
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    count = torch.cuda.device_count()
    home = ks.device
    cl, cr = JOIN_CUT
    buckets = max(8, len(vals) // 8)
    lk, rk = vals % buckets, vals[len(vals) - len(vals) // 2:] % buckets
    want_cut = np.argwhere(lk[:cl, None] == rk[None, :cr])
    join_raw = join["nested_sharded"]["raw_grid"]
    # the paper scan's query, truth and unplaced raw values
    lo, hi = (int(v) for v in np.percentile(lk[:cl], [30, 70]))
    pq = P.Range("k", E.encrypt(wks, lo, SEED + 120),
                 E.encrypt(wks, hi, SEED + 121))
    p_want = (lk[:cl] >= lo) & (lk[:cl] <= hi)
    p_raw, stop_raw = record_raw(SX, "sharded_fused_eval")
    flat = db.ShardedTable.from_table(
        wks, pl, spec=db.ShardSpec.create(SHARDS, use_mesh=False))
    p_flat = db.execute(wks, flat, pq)
    stop_raw()
    del flat
    meshes = {"visible": {},
              "positions": {"devices": [
                  torch.device("cuda", j % count) if home.type == "cuda"
                  else home for j in range(SHARDS)]}}
    runs = []
    for name, kw in meshes.items():
        spec = db.ShardSpec.create(SHARDS, **kw)
        cards = [str(d) for d in spec.mesh.distinct]
        gc.collect()
        torch.cuda.empty_cache()
        for c in range(count):
            torch.cuda.reset_peak_memory_stats(c)
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        gshapes, stop_g = record_gadget_shapes()
        pshapes, stop_p = record_paper_shapes()
        scan_raw, stop_s = record_raw(SX, "sharded_fused_eval")
        grid_raw, stop_j = record_raw(SJ, "sharded_pair_eval")
        try:
            t0 = time.perf_counter()
            table = Table.from_arrays(ks, "hg38", {"value": vals}, SEED + 1)
            st = db.ShardedTable.from_table(ks, table, spec=spec)
            partition_s = sync_s(t0)
            del table
            t = _shard_traffic(ks, st, vals, base["reqs"], base["q_top"])
            rows = st.columns["value"]       # rows of the first slab
            source = type(rows)(*(x.slabs[0].reshape(-1, *x.shape[2:])
                                  .clone() for x in rows))
            d = st.spec.mesh_devices
            slabs = rows.c0.num_slabs
            del st, t["server"], t["index"], rows
            gc.collect()
            t0 = time.perf_counter()
            sl = db.ShardedTable.from_table(ks, lcut, spec=spec)
            sr = db.ShardedTable.from_table(ks, rcut, spec=spec)
            joined = db.execute_join(ks, sl, sr, P.Join(None, None, on="k"),
                                     strategy="nested")
            join_s = sync_s(t0)
            before = [torch.cuda.max_memory_allocated(c)
                      for c in range(count)]
            for c in range(count):
                torch.cuda.reset_peak_memory_stats(c)
            t0 = time.perf_counter()
            merged = db.execute_join(ks, sl, sr, P.Join(None, None, on="k"),
                                     strategy="sort_merge")
            sort_merge_s = sync_s(t0)
            sm_peaks = {f"cuda:{c}": torch.cuda.max_memory_allocated(c)
                        for c in range(count)}
            del sl, sr
            t0 = time.perf_counter()
            pt = db.ShardedTable.from_table(wks, pl, spec=spec)
            pscan = db.execute(wks, pt, pq)
            paper_s = sync_s(t0)
            del pt
            torch.cuda.synchronize()
            launches = dict(_build.LAUNCHES)
        finally:
            stop_g()
            stop_p()
            hash_s = stop_s() + stop_j()
        peaks = {f"cuda:{c}": max(before[c],
                                  torch.cuda.max_memory_allocated(c))
                 for c in range(count)}
        answers_ok = _same_answers(t["answers"], base["answers"])
        truth_ok = bool(
            all(np.array_equal(r, np.nonzero(truth(vals))[0])
                for r, (_, truth) in zip(t["answers"]["served"],
                                         base["reqs"]))
            and all(np.array_equal(m, t["write_want"])
                    for m in t["answers"]["write_masks"])
            and np.array_equal(t["answers"]["probe_mask"],
                               vals == t["target"]))
        raw_ok = (scan_raw == base["raw"] + p_raw and grid_raw == join_raw)
        join_ok = bool(np.array_equal(joined.pairs, want_cut))
        # the join phase held the unsharded sort-merge's pairs on the cut
        # to want_cut
        sort_merge_ok = bool(np.array_equal(merged.pairs, want_cut))
        paper_ok = bool(np.array_equal(pscan.mask, p_want)
                        and np.array_equal(pscan.mask, p_flat.mask))
        gadget = check_gadget_shapes(ks, source, gshapes, SEED + 122, rate)
        del source
        # each card's paper shapes (its KeySet replica's) checked and
        # timed on that card, as the current device
        paper = {"equal": bool(pshapes), "shapes": []}
        for dev in spec.mesh.distinct:
            rid = id(wks.replica(dev).cek_rev)
            mine = {k: v for k, v in pshapes.items() if k[0] == rid}
            if not mine:
                continue
            col = type(pl.column("k"))(*(x.to(dev) for x in pl.column("k")))
            with (torch.cuda.device(dev) if dev.type == "cuda"
                  else contextlib.nullcontext()):
                got = check_paper_shapes({rid: (f"paper@{dev}", col)}, mine,
                                         SEED + 123, rate)
            paper["equal"] &= got["equal"]
            paper["shapes"] += got["shapes"]
        g_calls = sum(x["calls"] * x["launches_per_call"]
                      for x in gadget["shapes"])
        p_calls = sum(x["calls"] for x in paper["shapes"])
        reconciled = (g_calls == launches["eval_coeff0_gadget"]
                      and p_calls == launches["eval_coeff0_paper"])
        run = {
            "mesh": name, "device_count": count, "d": d, "slabs": slabs,
            "cards": cards, "positions": [str(x) for x in spec.mesh.devices],
            "degenerate": d == 1,
            "raw_scans": len(scan_raw), "raw_grids": len(grid_raw),
            "raw_equal": raw_ok, "answers_equal": answers_ok,
            "truth_ok": truth_ok, "join_exact": join_ok,
            "join_pairs": int(len(joined.pairs)),
            "join_eval_calls": joined.stats.eval_calls,
            "sort_merge_exact": sort_merge_ok,
            "sort_merge": {k: getattr(merged.stats, k) for k in (
                "eval_calls", "build_compares", "merge_compares",
                "adjacency_compares")} | {"peak_mem_bytes": sm_peaks},
            "paper_scan_exact": paper_ok,
            "mesh_devices_in_stats": [
                t["res"][t["ids"][-1]].stats.mesh_devices,
                joined.stats.left.mesh_devices],
            "walls": {"partition_s": partition_s, **t["walls"],
                      "nested_join_s": join_s,
                      "sort_merge_join_s": sort_merge_s,
                      "paper_scan_s": paper_s,
                      "raw_hash_s": hash_s},
            "unplaced_walls": base["walls"], "peak_mem_bytes": peaks,
            "launches": launches, "gadget_shapes": gadget,
            "paper_shapes": paper, "launches_reconciled": reconciled}
        if d == 1:
            run["note"] = (f"{count} card(s) visible: ShardSpec.create("
                           f"{SHARDS}) has d = 1, the unplaced layout")
        emit({"phase": "placement", **run})
        runs.append(run)
        require(raw_ok, f"placed raw values differ from unplaced ({name})")
        require(answers_ok and truth_ok,
                f"placed answers differ from unplaced or the truth ({name})")
        require(join_ok, f"the placed [{SHARDS}x{SHARDS}] join's pairs "
                f"differ ({name})")
        require(sort_merge_ok, f"the placed [{SHARDS}x{SHARDS}] sort-merge "
                f"join's pairs differ ({name})")
        require(paper_ok, f"the placed paper scan differs ({name})")
        require(gadget["equal"] and paper["equal"],
                f"an Eval shape of the placed path != plain ({name})")
        require(reconciled, f"placed launches {launches} != the recorded "
                f"calls ({name})")
        require(all(launches[k] > 0 for k in PLACEMENT_KERNELS),
                f"a kernel never launched on the placed path: {launches}")
        require(d == len(spec.mesh.devices) and slabs == d
                and run["mesh_devices_in_stats"] == [d, d],
                f"mesh {name}: d = {d}, {slabs} slabs, stats "
                f"{run['mesh_devices_in_stats']}")
        require(name != "positions" or d == SHARDS,
                f"the explicit mesh has d = {d}, not {SHARDS}")
        del t, joined, merged, pscan
    torch.cuda.empty_cache()
    return {"phase": "placement", "device_count": count, "runs": runs}


def _pcts(lats) -> tuple:
    """(p50, p99) in milliseconds, numpy's linear percentiles as the
    serving-loop benchmark reports them."""
    return (float(np.percentile(lats, 50)) * 1e3,
            float(np.percentile(lats, 99)) * 1e3)


def _loop_tenant(dev, name, seed, n_rows, n_padded, with_right=False,
                 with_w=False):
    """One tenant's world as the benchmark's `_mk_tenant`: its own paper
    KeySet, its own indexed table (and a 64-row right table), a probe
    pool of 16 values and 8 range bounds.  Each probe carries its truth,
    and the join its pairs, computed here: no check runs inside the
    loop's timed windows.  `with_w` adds an unindexed column `w` (drawn
    after the pool and bounds, so `v`'s world is the same) that bulk
    Ranges scan."""
    import torch
    from repro_torch.core import encrypt as E
    from repro_torch.core.keys import keygen
    from repro_torch.core.params import make_params
    from repro_torch.db.index import SortedIndex
    from repro_torch.db.table import Table

    ks = keygen(make_params(LOOP_PROFILE, mode="paper"), seed, device=dev,
                paper_ecek_weight=0)
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, ks.params.max_operand // 2,
                        n_rows).astype(np.int64)
    picks = rng.choice(vals, 16, replace=True)
    spans = [tuple(int(v) for v in np.sort(rng.choice(vals, 2,
                                                      replace=False)))
             for _ in range(8)]
    data = {"v": vals}
    if with_w:
        data["w"] = rng.integers(0, ks.params.max_operand // 2,
                                 n_rows).astype(np.int64)
    t0 = time.perf_counter()
    table = Table.from_arrays(ks, f"{name}_t", data, seed + 1,
                              n_padded=n_padded)
    torch.cuda.synchronize()
    encrypt_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    index = SortedIndex.build(ks, table, "v")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    right = pairs = None
    if with_right:
        rvals = vals[:64].copy()
        right = Table.from_arrays(ks, f"{name}_r", {"v": rvals}, seed + 2)
        pairs = np.argwhere(vals[:, None] == rvals[None, :])
    pool = [(E.encrypt(ks, int(v), seed + 10 + i), np.nonzero(vals == v)[0])
            for i, v in enumerate(picks)]
    bounds = [(E.encrypt(ks, lo, seed + 100 + i),
               E.encrypt(ks, hi, seed + 200 + i),
               np.nonzero((vals >= lo) & (vals <= hi))[0])
              for i, (lo, hi) in enumerate(spans)]
    return dict(name=name, ks=ks, rng=rng, vals=vals, data=data,
                table=table, index=index, right=right, pairs=pairs,
                pool=pool, picks=picks, bounds=bounds,
                encrypt_s=encrypt_s, index_build_s=build_s,
                index_sorted=bool(np.array_equal(vals[index.perm],
                                                  np.sort(vals))))


def _on_host(res) -> bool:
    """A served result's row ids, mask and pairs are host arrays."""
    return all(isinstance(getattr(res, f, np.zeros(0)), np.ndarray)
               for f in ("row_ids", "mask", "pairs"))


def _rows_are(ids):
    """A check: the result's row ids, sorted, are `ids`."""
    return lambda r: np.array_equal(np.sort(r.row_ids), ids)


class _Traffic:
    """What the serving-loop phases (11, 11a, 11c) share around one
    `ServeLoop`: every ticket is submitted with the check its answer
    must pass, and `drain` runs the loop until idle, holds each OK
    answer to its check (host arrays), keeps anything else than OK,
    REJECTED or SHED in `bad`, tallies each terminal status per tenant
    and forgets the checked tickets.  Tickets submitted without a check
    (a poisoned plan) are tallied but kept for the caller to read.
    Client threads may submit while the daemon pump runs."""

    def __init__(self, loop):
        import threading
        self.loop, self.expect, self.bad = loop, {}, []
        self.submitted: dict = {}        # tenant -> tickets submitted
        self.tally: dict = {}            # tenant -> {status: count}
        self._seen: set = set()
        self._lock = threading.Lock()

    def _count(self, tenant, tk, check):
        with self._lock:
            self.submitted[tenant] = self.submitted.get(tenant, 0) + 1
            if check is not None:
                self.expect[tk] = check
        return tk

    def submit(self, tenant, table, query, check=None, **kw):
        return self._count(tenant, self.loop.submit(tenant, table, query,
                                                    **kw), check)

    def join(self, tenant, table, join, right, check=None, **kw):
        return self._count(tenant, self.loop.submit_join(
            tenant, table, join, right, **kw), check)

    def write(self, kind, tenant, table, *args, check=None, **kw):
        fn = getattr(self.loop, f"submit_{kind}")
        return self._count(tenant, fn(tenant, table, *args, **kw), check)

    def drain(self) -> dict:
        from repro_torch.db.serve_loop import OK, REJECTED, SHED
        res = self.loop.run_until_idle()
        for tk, r in res.items():
            if tk not in self._seen:
                self._seen.add(tk)
                per = self.tally.setdefault(r.tenant, {})
                per[r.status] = per.get(r.status, 0) + 1
            if tk not in self.expect:
                continue
            check = self.expect.pop(tk)
            if r.status == OK and not (_on_host(r.result)
                                       and check(r.result)):
                self.bad.append((tk, r.klass, "wrong answer"))
            elif r.status not in (OK, REJECTED, SHED):
                self.bad.append((tk, r.klass, r.status, r.error))
            self.loop.forget(tk)
        return res

    def reconciled(self) -> dict:
        """Per tenant: submitted, the tally of terminal statuses, and
        whether submitted = ok + rejected + shed + failed and the loop's
        `serve.rejected/shed/failed` counters equal the tally."""
        from repro_torch import obs
        out = {}
        for t, n in self.submitted.items():
            per = self.tally.get(t, {})
            counters = {s: obs.REGISTRY.value(f"serve.{s.lower()}",
                                              tenant=t)
                        for s in ("REJECTED", "SHED", "FAILED")}
            out[t] = {"submitted": n, **per,
                      "ok": n == sum(per.values()) and all(
                          counters[s] == per.get(s, 0) for s in counters)}
        return out


def _latencies(res, tickets) -> list:
    """Each OK ticket's submit-to-answer seconds."""
    return [res[t].latency_s for t in tickets if res[t].status == "OK"]


def _threaded_round(traffic, clients) -> dict:
    """The always-on mode: the loop's daemon pump serves `clients`, each a
    thread that encrypts 4 values drawn from its own and submits each as
    an Eq (`clients`: (keys, values, rng, seed, probe), `probe(ct, v)`
    submitting and returning (ticket, truth rows)); then the pump stops.
    Every answer must equal its truth and the pump thread be joined."""
    import threading

    from repro_torch.core import encrypt as E
    from repro_torch.db.serve_loop import OK
    loop, tickets = traffic.loop, {}

    def client(ks, vals, rng, seed, probe):
        for i, v in enumerate(rng.choice(vals, 4)):
            tk, want = probe(E.encrypt(ks, int(v), seed + i), int(v))
            tickets[tk] = want
    t0 = time.perf_counter()
    loop.start(interval_s=0.001)
    try:
        threads = [threading.Thread(target=client, args=c) for c in clients]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        stop_at = time.monotonic() + 300.0
        while (any(not loop.response(tk).done for tk in tickets)
               and time.monotonic() < stop_at):
            time.sleep(0.005)
    finally:
        loop.stop()
    wall = time.perf_counter() - t0
    ok = all(loop.response(tk).status == OK
             and _on_host(loop.response(tk).result)
             and np.array_equal(np.sort(loop.response(tk).result.row_ids),
                                want)
             for tk, want in tickets.items()) and loop._thread is None
    traffic.drain()
    return {"ok": ok, "requests": len(tickets), "wall_s": wall}


def _overload(table, server, tenant, pool) -> dict:
    """Admission control on a loop with a tenant cap of 4 over `server`:
    a request already past its deadline is SHED, and of a burst of 8 the
    5 past the cap are REJECTED; the 3 admitted answer exactly."""
    from repro_torch.db import plan as P
    from repro_torch.db.serve_loop import (OK, REJECTED, SHED,
                                           AdmissionPolicy, ServeLoop)
    tight = ServeLoop(policy=AdmissionPolicy(tenant_queue_cap=4), batch=8)
    tight.register(table, server, tenants=(tenant,))
    late = tight.submit(tenant, table, P.Eq("v", pool[0][0]),
                        deadline=time.monotonic() - 1.0)
    burst = [tight.submit(tenant, table, P.Eq("v", pool[i % 16][0]))
             for i in range(8)]
    res = tight.run_until_idle()
    rejected = sum(res[t].status == REJECTED for t in burst)
    ok = (rejected == 5 and res[late].status == SHED
          and all(res[t].status == OK and np.array_equal(
              np.sort(res[t].result.row_ids), pool[i % 16][1])
              for i, t in enumerate(burst) if res[t].status != REJECTED))
    return {"rejected": rejected, "late": res[late].status, "ok": ok,
            "stats": dict(vars(tight.stats))}


def _loop_kernel_checks(sources, pshapes, mshapes, launches, ks, seed,
                        rate, ncalls=None) -> dict:
    """The paper Eval and both multiplies against their plain versions at
    every shape a loop path launched them at (`record_paper_shapes`,
    `record_mul_shapes`), and `ntt_br` at each call `ncalls` recorded;
    their calls reconciled with the launch counts.  `sources` maps the id
    of each key's `cek_rev` (a tenant's, or its replica's on another
    card) to (label, rows of that tenant's column on that card): each
    key's paper shapes are checked on its own rows, with its card
    current.  A shape whose key has no source fails the check."""
    import torch
    paper = {"equal": set(k[0] for k in pshapes) <= set(sources),
             "shapes": []}
    for rid, src in sources.items():
        mine = {k: v for k, v in pshapes.items() if k[0] == rid}
        if not mine:
            continue
        dev = src[1].c0.device
        with (torch.cuda.device(dev) if dev.type == "cuda"
              else contextlib.nullcontext()):
            got = check_paper_shapes({rid: src}, mine, seed, rate)
        paper["equal"] &= got["equal"]
        paper["shapes"] += got["shapes"]
        paper.setdefault("floor", got["floor"])
    muls = check_mul_shapes(ks, mshapes, seed + 1, rate)
    m_calls = {k: sum(s["calls"] for s in muls["shapes"] if s["kind"] == k)
               for k in ("key", "var")}
    reconciled = (sum(s["calls"] for s in paper["shapes"])
                  == launches["eval_coeff0_paper"]
                  and m_calls["key"] == launches["negacyclic_mul_ntt"]
                  and m_calls["var"] == launches["negacyclic_mul"])
    out = {"paper_shapes": paper, "mul_shapes": muls}
    equal = paper["equal"] and muls["equal"]
    if ncalls is not None:
        out["ntt_calls"] = check_ntt_calls(ncalls, launches, rate)
        equal &= out["ntt_calls"]["equal"]
        reconciled &= out["ntt_calls"]["launches_reconciled"]
    return {**out, "equal": equal, "launches_reconciled": reconciled}


def phase_loop(dev, rate) -> dict:
    """`benchmarks/serve_loop.py::run` at LOOP_ROWS = 65,536 (its rows
    argument; 57,344 live rows a tenant), every answer held against the
    plaintext: two tenants with their own paper keys and ACLed indexed
    tables behind one ServeLoop, alice's hot write table, then warm-up,
    isolated points, the steady mix and the overload, as the benchmark
    runs them; then a poisoned plan in a shared drain and a round in the
    always-on mode with two client threads.  Launch counts are zeroed
    just before the path and read just after; the paper Eval and both
    multiplies are then held against their plain versions at every shape
    the path gave them, and their calls against the launch counts."""
    import torch
    from repro_torch import obs
    from repro_torch.core import encrypt as E
    from repro_torch.db import plan as P
    from repro_torch.db.index import SortedIndex
    from repro_torch.db.query_serve import QueryServer
    from repro_torch.db.serve_loop import ServeLoop
    from repro_torch.db.table import Table
    from repro_torch.kernels import _build

    rows = LOOP_ROWS
    n_rows = rows - max(rows // 8, 4 * LOOP_COMPACT_AT)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    pshapes, pstop = record_paper_shapes()
    mshapes, mstop = record_mul_shapes()
    obs.enable()                 # launch accounting + serve.* counters
    obs.REGISTRY.reset()
    obs.jitwatch.reset()
    t_start = time.perf_counter()
    alice = _loop_tenant(dev, "alice", 11, n_rows, rows)
    bob = _loop_tenant(dev, "bob", 23, n_rows, rows, with_right=True)
    tenants = (alice, bob)
    loop = ServeLoop(batch=8)
    for t in tenants:
        loop.register(t["name"] + "_t", QueryServer(
            t["ks"], t["table"], indexes={"v": t["index"]}, batch=8,
            compact_threshold=LOOP_COMPACT_AT), tenants=(t["name"],))
    aks = alice["ks"]
    lim = aks.params.max_operand // 2
    wvals = alice["rng"].integers(0, lim, 2 * LOOP_COMPACT_AT).astype(
        np.int64)
    wtable = Table.from_arrays(aks, "alice_w", {"v": wvals}, 31,
                               n_padded=8 * LOOP_COMPACT_AT)
    wserver = QueryServer(aks, wtable,
                          indexes={"v": SortedIndex.build(aks, wtable, "v")},
                          batch=8, compact_threshold=LOOP_COMPACT_AT)
    loop.register("alice_w", wserver, tenants=("alice",))
    wprobe = E.encrypt(aks, int(wvals[0]), 32)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start

    traffic = _Traffic(loop)
    w_all = [wvals]              # alice_w's rows in global-id order

    def point_wave(t, n, deadline_s=None):
        dl = None if deadline_s is None else time.monotonic() + deadline_s
        return [traffic.submit(t["name"], t["name"] + "_t", P.Eq("v", ct),
                               _rows_are(truth), deadline=dl)
                for ct, truth in (t["pool"][i % 16] for i in range(n))]

    def bulk_wave(t, n):
        return [traffic.submit(t["name"], t["name"] + "_t",
                               P.Range("v", lo, hi), _rows_are(truth),
                               klass="bulk")
                for lo, hi, truth in (t["bounds"][i % 8] for i in range(n))]

    def insert_chunk(i):
        data = alice["rng"].integers(0, lim, LOOP_INSERT_CHUNK).astype(
            np.int64)
        start = sum(len(c) for c in w_all)
        w_all.append(data)
        traffic.write("insert", "alice", "alice_w", {"v": data}, 7000 + i,
                      check=lambda r, s=start: np.array_equal(
                          r.row_ids, np.arange(s, s + LOOP_INSERT_CHUNK)))

    def union_probe():
        truth = np.nonzero(np.concatenate(w_all) == wvals[0])[0]
        return traffic.submit("alice", "alice_w", P.Eq("v", wprobe),
                              _rows_are(truth))

    def join_one(t):
        traffic.join(t["name"], t["name"] + "_t",
                     P.Join(None, None, on="v"), t["right"],
                     strategy="nested",
                     check=lambda r: np.array_equal(
                         r.pairs[np.lexsort(r.pairs.T[::-1])], t["pairs"]))

    drain = traffic.drain
    walls = {}
    t0 = time.perf_counter()
    # ---- warm-up: every pow2 bucket, the join grid, one delta cycle ------
    for n in (8, 4, 2, 1):
        point_wave(alice, n)
        point_wave(bob, n)
        drain()
    for n in (4, 2, 1):
        bulk_wave(alice, n)
        bulk_wave(bob, n)
        drain()
    join_one(bob)
    drain()
    for i in range(LOOP_COMPACT_AT // LOOP_INSERT_CHUNK):
        insert_chunk(i)
        union_probe()
        drain()
    compactions = len(wserver.compaction_log)
    wserver.compact_threshold = 1 << 30
    max_chunks = LOOP_COMPACT_AT // LOOP_INSERT_CHUNK

    def flush_writes(i):
        wserver.compact_threshold = 1
        insert_chunk(i)
        drain()
        wserver.compact_threshold = 1 << 30
    walls["warmup_s"] = time.perf_counter() - t0

    # ---- isolated points (+ the writes, as the benchmark) ---------------
    t0 = time.perf_counter()
    iso_lat, chunks = [], 0
    for r in range(LOOP_ROUNDS):
        if chunks < max_chunks:
            insert_chunk(50 + r)
            chunks += 1
        tks = point_wave(alice, 8) + point_wave(bob, 8)
        iso_lat += _latencies(drain(), tks)
    iso = _pcts(iso_lat)
    flush_writes(90)
    walls["isolated_s"] = time.perf_counter() - t0

    # ---- steady mix ------------------------------------------------------
    retr0 = obs.bench_fields()["jit_retraces"]
    sub0, served0, shed0 = (loop.stats.submitted, loop.stats.served,
                            loop.stats.shed)
    mixed_point, mixed_bulk, union_lat, chunks = [], [], [], 0
    t0 = time.perf_counter()
    for r in range(LOOP_ROUNDS):
        ptks = point_wave(alice, 8, 600.0) + point_wave(bob, 8, 600.0)
        btks = bulk_wave(alice, 4) + bulk_wave(bob, 4)
        join_one(bob)
        utks = []
        if chunks < max_chunks:
            insert_chunk(100 + r)
            utks.append(union_probe())
            chunks += 1
        res = drain()
        mixed_point += _latencies(res, ptks)
        mixed_bulk += _latencies(res, btks)
        union_lat += _latencies(res, utks)
    steady_s = time.perf_counter() - t0
    served = loop.stats.served - served0
    shed_rate = (loop.stats.shed - shed0) / max(
        1, loop.stats.submitted - sub0)
    retrace_delta = obs.bench_fields()["jit_retraces"] - retr0
    signatures = obs.jit_signatures()
    mix, blk = _pcts(mixed_point), _pcts(mixed_bulk)
    uni = _pcts(union_lat) if union_lat else (None, None)
    ratio = mix[1] / iso[1]

    # ---- a poisoned plan sharing a drain with three good requests -------
    poison = []
    for i in range(3):
        bulk_wave(alice, 1)
        if i == 1:
            poison.append(traffic.submit(
                "alice", "alice_t", P.Eq("nope", alice["pool"][0][0]),
                klass="bulk"))
    res = drain()
    poison_ok = (res[poison[0]].status == "FAILED"
                 and "nope" in res[poison[0]].error)
    shapes_fault = loop.batch_shapes[-5:]

    # ---- the always-on mode: a daemon pump, two client threads ----------
    def probe(t):
        def submit(ct, v):
            want = np.nonzero(t["vals"] == v)[0]
            return traffic.submit(t["name"], t["name"] + "_t",
                                  P.Eq("v", ct), _rows_are(want)), want
        return submit
    threaded = _threaded_round(traffic, [
        (t["ks"], t["vals"], t["rng"], 9000 + 10 * k, probe(t))
        for k, t in enumerate(tenants)])
    walls["threaded_s"] = threaded["wall_s"]
    stats = dict(vars(loop.stats))
    launches = dict(_build.LAUNCHES)
    pstop()
    mstop()

    # ---- overload: admission control rejects and sheds explicitly -------
    overload = _overload("alice_t", QueryServer(
        aks, alice["table"], indexes={"v": alice["index"]}, batch=8),
        "alice", alice["pool"])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    obs.disable()

    # ---- each kernel at every shape the path gave it, on tenants' rows ---
    kernels = _loop_kernel_checks(
        {id(t["ks"].cek_rev): (t["name"], t["table"].columns["v"])
         for t in tenants}, pshapes, mshapes, launches, aks, SEED + 50,
        rate)
    bad = traffic.bad
    out = {
        "phase": "loop", "profile": LOOP_PROFILE, "mode": "paper",
        "rows_arg": rows, "rows": n_rows, "rounds": LOOP_ROUNDS,
        "index_build_s": [t["index_build_s"] for t in tenants],
        "encrypt_s": [t["encrypt_s"] for t in tenants],
        "index_sorted": all(t["index_sorted"] for t in tenants),
        "setup_s": setup_s, "walls": walls,
        "point_isolated_ms": {"p50": iso[0], "p99": iso[1],
                              "n": len(iso_lat)},
        "point_mixed_ms": {"p50": mix[0], "p99": mix[1],
                           "n": len(mixed_point)},
        "p99_vs_isolated": ratio,
        "bulk_mixed_ms": {"p50": blk[0], "p99": blk[1],
                          "n": len(mixed_bulk)},
        "union_read_ms": {"p50": uni[0], "p99": uni[1],
                          "n": len(union_lat)},
        "steady_s": steady_s, "steady_qps": served / steady_s,
        "shed_rate": shed_rate, "jit_retraces_delta": retrace_delta,
        "launch_signatures": {k: len(v) for k, v in signatures.items()},
        "write_chunks": chunks, "warmup_compactions": compactions,
        "exact": not bad, "wrong": bad[:5],
        "poisoned_failed_alone": poison_ok, "fault_batches": shapes_fault,
        "threaded_exact": threaded["ok"],
        "threaded_requests": threaded["requests"],
        "overload": {k: overload[k] for k in ("rejected", "late", "ok")},
        "loop_stats": stats, "launches": launches, "peak_mem_bytes": peak,
        "launches_reconciled": kernels["launches_reconciled"],
        "paper_shapes": kernels["paper_shapes"],
        "mul_shapes": kernels["mul_shapes"],
    }
    emit(out)
    require(out["index_sorted"], "a tenant's index is not sorted")
    require(not bad, f"loop answers diverged from the plaintext: {bad[:5]}")
    require(poison_ok, "the poisoned plan did not fail alone")
    require(stats["failed"] == 1, f"failed {stats['failed']} != 1 poisoned")
    require(stats["served"] == stats["admitted"] - stats["shed"] - 1,
            f"served {stats['served']} != every other request: {stats}")
    require(stats["shed"] == 0 and stats["rejected"] == 0,
            f"the light-load loop shed or rejected: {stats}")
    require(ratio <= 2.0, f"point p99 {ratio:.2f}x its isolated p99")
    require(shed_rate == 0.0, f"shed under light load: {shed_rate}")
    require(retrace_delta == 0,
            f"{retrace_delta} new launch signatures in the steady mix: "
            f"{signatures}")
    require(threaded["ok"], "the always-on round answered wrong")
    require(overload["ok"], f"overload: {out['overload']}")
    require(kernels["equal"], "a kernel != plain at a shape of the loop path")
    require(kernels["launches_reconciled"],
            f"launches {launches} != the recorded calls")
    require(all(launches[k] > 0 for k in LOOP_KERNELS),
            f"a kernel never launched on the loop path: {launches}")
    return out


class _Plain:
    """The plaintext of a served table's global row ids (`v`, `w`, alive)
    as the writes admitted so far leave it, and the truth of each plan
    the sharded loop phase sends.  `epoch` counts the writes, so (plan,
    epoch) names one answer."""

    def __init__(self, data):
        self.v, self.w = data["v"].copy(), data["w"].copy()
        self.alive = np.ones(len(self.v), bool)
        self.epoch = 0

    def insert(self, v, w) -> np.ndarray:
        ids = np.arange(len(self.v), len(self.v) + len(v))
        self.v = np.concatenate([self.v, v])
        self.w = np.concatenate([self.w, w])
        self.alive = np.concatenate([self.alive, np.ones(len(v), bool)])
        self.epoch += 1
        return ids

    def delete(self, rows) -> int:
        newly = int(self.alive[rows].sum())
        self.alive[rows] = False
        self.epoch += 1
        return newly

    def eq(self, x) -> np.ndarray:
        return np.nonzero((self.v == x) & self.alive)[0]

    def range(self, col, lo, hi) -> np.ndarray:
        x = getattr(self, col)
        return np.nonzero((x >= lo) & (x <= hi) & self.alive)[0]

    def top(self, lo, hi, k) -> list:
        """The k largest `v` (with repeats) where lo <= w <= hi."""
        sel = self.range("w", lo, hi)
        return sorted(self.v[sel].tolist(), reverse=True)[:k]


def _device_allocs() -> int:
    """The caching allocator's `cudaMalloc` calls so far, summed over
    the visible cards (0 without a card)."""
    import torch
    if not torch.cuda.is_available():
        return 0
    return sum(torch.cuda.memory_stats(c).get("num_device_alloc", 0)
               for c in range(torch.cuda.device_count()))


@contextlib.contextmanager
def _gc_pauses():
    """Python's cyclic collections inside the block, each [start, end,
    generation] on the loop's clock (`time.monotonic`), from whichever
    thread ran them."""
    pauses = []

    def seen(phase, info):
        if phase == "start":
            pauses.append([time.monotonic(), None, info["generation"]])
        elif pauses and pauses[-1][1] is None:
            pauses[-1][1] = time.monotonic()
    gc.callbacks.append(seen)
    try:
        yield pauses
    finally:
        gc.callbacks.remove(seen)
        for p in pauses:
            if p[1] is None:
                p[1] = p[0]


def _loop_shard_script(alice) -> dict:
    """What phase 11a sends besides alice's probe pool, encrypted once
    and shared by every layout: 8 Ranges on `w`, the TopK 8 (by `v`,
    where `w` lies in its 30th-70th percentiles), the write wave's rows
    (4 chunks of LOOP_INSERT_CHUNK, each with an Eq probe of its first
    value), its delete (a base row and an inserted one) and its update
    (one row, with its probe)."""
    from repro_torch.core import encrypt as E
    ks, w = alice["ks"], alice["data"]["w"]
    rng = np.random.default_rng(SEED + 70)
    lim, n = ks.params.max_operand // 2, len(w)

    def enc(v, seed):
        return E.encrypt(ks, int(v), seed)
    spans = [tuple(int(x) for x in np.sort(rng.choice(w, 2, replace=False)))
             for _ in range(8)]
    wb = [(enc(lo, SEED + 300 + i), enc(hi, SEED + 400 + i), lo, hi)
          for i, (lo, hi) in enumerate(spans)]
    top = tuple(int(x) for x in np.percentile(w, [30, 70]))
    chunks = [{"v": rng.integers(0, lim, LOOP_INSERT_CHUNK),
               "w": rng.integers(0, lim, LOOP_INSERT_CHUNK)}
              for _ in range(LOOP_COMPACT_AT // LOOP_INSERT_CHUNK)]
    upd = {"v": rng.integers(0, lim, 1), "w": rng.integers(0, lim, 1)}
    return {"w_bounds": wb,
            "topk": (enc(top[0], SEED + 500), enc(top[1], SEED + 501),
                     *top),
            "chunks": [(c, enc(c["v"][0], SEED + 510 + i))
                       for i, c in enumerate(chunks)],
            "dead": [0, n + 3], "update": (upd, [5],
                                           enc(upd["v"][0], SEED + 520))}


def _same_answer(a, b) -> bool:
    return np.array_equal(np.asarray(a), np.asarray(b))


def _loop_shard_traffic(traffic, table, alice, script, store) -> dict:
    """Phase 11a's stages against one registered table, as closures over
    it: each sends a stage and returns its tickets; every answer is held
    to the plaintext (`_Plain`, which replays the stages' writes) and
    kept in `store` under (plan, epoch): its sorted row ids, or the
    TopK's values."""
    from repro_torch.db import plan as P
    rows = _Plain(alice["data"])

    def keep(key, want, values=False):
        v = rows.v

        def check(r):
            got = v[r.row_ids].tolist() if values else np.sort(r.row_ids)
            store[key] = got
            return _same_answer(got, want)
        return check

    def probe(tenant, ct, x, deadline=None):
        """An Eq on `v` = x; returns (ticket, truth rows)."""
        want = rows.eq(x)
        return traffic.submit(tenant, table, P.Eq("v", ct),
                              keep(("eq", x, rows.epoch), want),
                              deadline=deadline), want

    def point(tenant, i, deadline_s=None):
        dl = None if deadline_s is None else time.monotonic() + deadline_s
        return probe(tenant, alice["pool"][i % 16][0],
                     int(alice["picks"][i % 16]), dl)[0]

    def w_range(tenant, i):
        lo_ct, hi_ct, lo, hi = script["w_bounds"][i % 8]
        return traffic.submit(tenant, table, P.Range("w", lo_ct, hi_ct),
                              keep(("w", lo, hi, rows.epoch),
                                   rows.range("w", lo, hi)), klass="bulk")

    def topk(tenant):
        lo_ct, hi_ct, lo, hi = script["topk"]
        q = P.Query(where=P.Range("w", lo_ct, hi_ct),
                    top_k=P.TopK("v", SHARD_TOPK))
        return traffic.submit(tenant, table, q, keep(
            ("top", lo, hi, rows.epoch), rows.top(lo, hi, SHARD_TOPK),
            values=True))

    def wave(per_tenant, n_bulk=0, deadline_s=None, with_topk=False):
        """Points from alice and bob, their bulk Ranges on `w`, and a
        TopK from bob: one drain's worth.  Returns (points, bulk)."""
        pts = [point(t, i, deadline_s) for t in ("alice", "bob")
               for i in range(per_tenant)]
        blk = [w_range(t, i) for t in ("alice", "bob")
               for i in range(n_bulk)]
        if with_topk:
            blk.append(topk("bob"))
        return pts, blk

    def writes():
        """The write wave, sent before one drain: LOOP_COMPACT_AT rows
        in chunks (the last reaches the compaction threshold, so
        compaction runs while the queries behind it wait), each chunk
        followed by an Eq probe of its first value and a Range on `w`;
        then the delete, the update and reads after them.  Returns the
        inserts' tickets."""
        ins = []
        for i, (data, ct) in enumerate(script["chunks"]):
            ids = rows.insert(data["v"], data["w"])
            ins.append(traffic.write(
                "insert", "alice", table, data, 7100 + i,
                check=lambda r, ids=ids: np.array_equal(r.row_ids, ids)))
            probe("alice", ct, int(data["v"][0]))
            w_range("bob", i)
        dead = script["dead"]
        n = rows.delete(dead)
        traffic.write("delete", "bob", table, dead,
                      check=lambda r, n=n: r.deleted == n)
        data, gone, ct = script["update"]
        rows.alive[gone] = False            # one write: tombstone + insert
        ids = rows.insert(data["v"], data["w"])
        traffic.write("update", "bob", table, gone, data, 7200,
                      check=lambda r, ids=ids: np.array_equal(r.row_ids,
                                                              ids))
        probe("alice", ct, int(data["v"][0]))
        point("alice", 0)
        w_range("bob", 4)
        topk("bob")
        return ins

    def poisoned():
        """A plan naming no column, between two good bulk Ranges; returns
        its ticket."""
        w_range("alice", 5)
        tk = traffic.submit("alice", table,
                            P.Eq("nope", alice["pool"][0][0]), klass="bulk")
        w_range("alice", 6)
        return tk

    return {"rows": rows, "wave": wave, "writes": writes,
            "poisoned": poisoned, "probe": probe}


def _loop_shard_run(alice, script, spec, rate, with_plain) -> dict:
    """One layout of phase 11a: alice's rows (`v`, `w`) encrypted straight
    into a ShardedTable under `spec` (the same seed in every layout, so
    the same ciphertexts), its ShardedIndex on `v`, a ShardedQueryServer
    with `compact_threshold` behind a ServeLoop(batch=8) (`with_plain`:
    the plain tenant's QueryServer over the same rows registered beside
    it; the stages whose plans or epochs no other stage has are replayed
    there after the sharded ones), then the traffic: warm-up, 64
    isolated points, the steady mix, a join (rejected at admission), the
    write wave (compaction under queued queries), a poisoned plan in a
    shared drain, one traced steady round, the always-on round with two
    client threads, the overload.  Launch counts are zeroed just before
    and read just after; every raw scan value is recorded (sha256); then
    each kernel against its plain version at every shape the run gave
    it.  Returns the record, its answers by (plan, epoch) and its raw
    records."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import db, obs
    from repro_torch.db import plan as P
    from repro_torch.db.serve_loop import FAILED, POINT, REJECTED, ServeLoop
    from repro_torch.db.shard import executor as SX
    from repro_torch.kernels import _build

    ks, home = alice["ks"], alice["ks"].device
    cards = range(torch.cuda.device_count() if home.type == "cuda" else 0)
    walls, peaks, comp = {}, {}, []

    def sync_s(t0):
        for c in cards:
            torch.cuda.synchronize(c)
        return time.perf_counter() - t0

    def peak(part):
        """Each card's peak since the last part (then reset)."""
        peaks[part] = {}
        for c in cards:
            torch.cuda.synchronize(c)
            peaks[part][f"cuda:{c}"] = torch.cuda.max_memory_allocated(c)
            torch.cuda.reset_peak_memory_stats(c)

    gc.collect()
    for c in cards:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(c)
    sync_s(0.0)
    _build.reset_launch_counts()
    pshapes, pstop = record_paper_shapes()
    mshapes, mstop = record_mul_shapes()
    ncalls, nstop = record_calls(("ntt_br",))
    raw, raw_stop = record_raw(SX, "sharded_fused_eval")
    obs.enable()                 # launch accounting + serve.* counters
    obs.REGISTRY.reset()
    obs.jitwatch.reset()
    t_run = time.perf_counter()
    try:
        # ---- the sharded tenant (and the plain one beside it) -----------
        t0 = time.perf_counter()
        st = db.ShardedTable.from_arrays(ks, "alice_s", alice["data"],
                                         SEED + 71, spec=spec)
        walls["encrypt_s"] = sync_s(t0)
        t0 = time.perf_counter()
        idx = db.ShardedIndex.build(ks, st, "v")
        walls["index_build_s"] = sync_s(t0)
        index_sorted = _shard_index_sorted(alice["vals"], st, idx)
        server = db.ShardedQueryServer(ks, st, indexes={"v": idx}, batch=8,
                                       compact_threshold=LOOP_COMPACT_AT)
        del idx                 # the server's index dict holds it alone
        geometry = {"shard_rows": st.shard_rows.tolist(),
                    "block": st.n_padded_per_shard,
                    "slabs": st.columns["v"].c0.num_slabs}
        loop = ServeLoop(batch=8)
        loop.register("alice_s", server, tenants=("alice", "bob"))
        traffic = _Traffic(loop)
        store, pstore = {}, {}
        sh = _loop_shard_traffic(traffic, "alice_s", alice, script, store)
        pl = None
        if with_plain:
            loop.register("alice_p", db.QueryServer(
                ks, alice["table"], indexes={"v": alice["index"]}, batch=8),
                tenants=("alice", "bob"))
            pl = _loop_shard_traffic(traffic, "alice_p", alice, script,
                                     pstore)

        def accounted() -> dict:
            """What each card should hold: the tenants' column stacks,
            delta runs and indexes (all else is a few MiB)."""
            by = {f"cuda:{c}": 0 for c in cards}
            t = alice["table"]                 # resident in every layout
            cts = [server.indexes["v"]._sorted, alice["index"].sorted_ct]
            tabs = ([d for d in st.deltas if d is not None] + [t]
                    + ([t.delta] if t.has_delta else []))
            halves = [h for ct in st.columns.values() for h in ct]
            tensors = ([x for h in halves for x in h.slabs]
                       + [x for ct in cts for x in ct]
                       + [x for t in tabs for ct in t.columns.values()
                          for x in ct])
            for x in tensors:
                if x.is_cuda:
                    by[f"cuda:{x.device.index}"] += x.nbytes
            return by

        inner_compact = server.compact

        def compact():
            """The server's compaction between two synchronizes, with
            what is queued behind it and what stays allocated after."""
            sync_s(0.0)              # the writes before it, finished
            t0 = time.perf_counter()
            stats = inner_compact()
            dt = sync_s(t0)
            comp.append({"s": dt, "queued": loop.queue_depth(),
                         "n_delta": stats.n_delta,
                         "merge_compares": stats.merge_compares,
                         "block_after": st.n_padded_per_shard,
                         "live_bytes": {f"cuda:{c}":
                                        torch.cuda.memory_allocated(c)
                                        for c in cards},
                         "accounted_bytes": accounted()})
            return stats
        server.compact = compact
        inner_insert, insert_walls, insert_allocs = st.insert, [], []

        def insert(*args, **kw):
            """The table's insert between two synchronizes, and the
            allocator's `cudaMalloc` calls during it."""
            sync_s(0.0)
            a0, t0 = _device_allocs(), time.perf_counter()
            ids = inner_insert(*args, **kw)
            insert_walls.append(sync_s(t0))
            insert_allocs.append(_device_allocs() - a0)
            return ids
        st.insert = insert
        peak("setup")

        def stage(name, *args, **kw):
            """A stage on the sharded tenant, drained; then (with the
            plain tenant) the same there, drained apart and untimed."""
            out = sh[name](*args, **kw)
            res = traffic.drain()
            if pl is not None:
                pl[name](*args, **kw)
                traffic.drain()
            return out, res

        # ---- warm-up: every pow2 bucket of both classes, the TopK -------
        t0 = time.perf_counter()
        for n in (8, 4, 2, 1):
            stage("wave", n)
        for n in (4, 2, 1):
            stage("wave", 0, n)
        stage("wave", 0, 4, with_topk=True)
        walls["warmup_s"] = sync_s(t0)

        # ---- 64 isolated point Eqs on the indexed v ---------------------
        t0 = time.perf_counter()
        iso_lat, iso_klass = [], True
        for _ in range(4):
            pts, _ = sh["wave"](8)
            res = traffic.drain()
            iso_lat += _latencies(res, pts)
            iso_klass &= all(res[t].klass == POINT for t in pts)
        walls["isolated_s"] = sync_s(t0)
        iso = _pcts(iso_lat)
        peak("reads")

        # ---- steady mix: points with deadlines, bulk Ranges, a TopK -----
        retr0 = obs.bench_fields()["jit_retraces"]
        served0 = loop.stats.served
        mixed_point, mixed_bulk = [], []
        t0 = time.perf_counter()
        for _ in range(LOOP_ROUNDS):
            pts, blk = sh["wave"](8, 4, 600.0, with_topk=True)
            res = traffic.drain()
            mixed_point += _latencies(res, pts)
            mixed_bulk += _latencies(res, blk)
        walls["steady_s"] = sync_s(t0)
        steady_served = loop.stats.served - served0
        retrace_delta = obs.bench_fields()["jit_retraces"] - retr0
        signatures = obs.jit_signatures()
        mix, blk_p = _pcts(mixed_point), _pcts(mixed_bulk)

        # ---- a join against the sharded tenant: rejected at admission ---
        before = dict(vars(loop.stats))
        depth, shapes0 = loop.queue_depth(), len(loop.batch_shapes)
        jt = traffic.join("bob", "alice_s", P.Join(None, None, on="v"),
                          alice["table"])
        jr = loop.response(jt)
        join_ok = (jr.status == REJECTED
                   and "does not support joins" in jr.error
                   and vars(loop.stats) == dict(
                       before, submitted=before["submitted"] + 1,
                       rejected=before["rejected"] + 1)
                   and loop.queue_depth() == depth
                   and len(loop.batch_shapes) == shapes0)
        traffic.drain()

        # ---- the write wave: compaction while queries wait --------------
        t0 = time.perf_counter()
        with _gc_pauses() as pauses:
            ins, res = stage("writes")
        walls["write_wave_s"] = sync_s(t0)
        peak("writes")
        service = [(res[t].start_t, res[t].done_t) for t in ins]
        walls["insert_service_s"] = [b - a for a, b in service]
        walls["insert_s"] = insert_walls[:len(ins)]
        insert_driver_allocs = insert_allocs[:len(ins)]
        insert_s = sum(b - a for a, b in service) - sum(c["s"] for c in comp)
        gc_write = {"collections": len(pauses),
                    "generations": [g for *_, g in pauses],
                    "s": sum(b - a for a, b, _ in pauses),
                    "in_inserts_s": [sum(max(0.0, min(b, d) - max(a, s0))
                                         for a, b, _ in pauses)
                                     for s0, d in service]}

        # ---- a poisoned plan in a shared drain ---------------------------
        failed0 = loop.stats.failed
        bad_tk, res = stage("poisoned")
        poison_ok = (res[bad_tk].status == FAILED
                     and "nope" in res[bad_tk].error
                     and loop.stats.failed - failed0 == 1 + with_plain)

        # ---- one steady round under torch.profiler (busy share) ---------
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if len(cards) else [])
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            sh["wave"](8, 4, 600.0, with_topk=True)
            traffic.drain()
            walls["traced_round_s"] = sync_s(t0)
        busy = _device_summary(prof, walls["traced_round_s"])
        del prof
        if pl is not None:
            pl["wave"](8, 4, 600.0, with_topk=True)
            traffic.drain()

        # ---- the always-on round: a daemon pump, two client threads -----
        rows, sent = sh["rows"], []

        def client_probe(tenant):
            def probe(ct, x):
                sent.append((tenant, ct, x))
                return sh["probe"](tenant, ct, x)
            return probe
        threaded = _threaded_round(traffic, [
            (ks, rows.v[rows.alive], np.random.default_rng(SEED + 80 + k),
             9100 + 10 * k, client_probe(t))
            for k, t in enumerate(("alice", "bob"))])
        walls["threaded_s"] = threaded["wall_s"]
        if pl is not None:
            for tenant, ct, x in sent:
                pl["probe"](tenant, ct, x)
            traffic.drain()
        stats = dict(vars(loop.stats))
        tenants = traffic.reconciled()
        bad = traffic.bad
        launches = dict(_build.LAUNCHES)
    finally:
        pstop()
        mstop()
        nstop()
        walls["raw_hash_s"] = raw_stop()
    overload = _overload("alice_s", db.ShardedQueryServer(
        ks, st, indexes=server.indexes, batch=8), "alice",
        [(ct, rows.eq(int(x))) for (ct, _), x in zip(alice["pool"],
                                                     alice["picks"])])
    obs.disable()
    walls["run_s"] = sync_s(t_run)
    peak("end")
    after = {"shard_rows": st.shard_rows.tolist(),
             "block": st.n_padded_per_shard, "n_delta": st.n_delta}
    del st, server, loop, traffic, sh, pl
    gc.collect()
    for c in cards:
        torch.cuda.empty_cache()

    # ---- each kernel at every shape the run gave it ----------------------
    col = alice["table"].columns["v"]
    n_sp = geometry["block"]
    sources = {id(ks.cek_rev): ("alice", col)}
    for dev in (spec.mesh.distinct if spec.mesh is not None else ()):
        if dev != home:
            sources[id(ks.replica(dev).cek_rev)] = (
                f"alice@{dev}", type(col)(col.c0[:n_sp].to(dev),
                                          col.c1[:n_sp].to(dev)))
    kernels = _loop_kernel_checks(sources, pshapes, mshapes, launches, ks,
                                  SEED + 72, rate, ncalls=ncalls)
    del sources, ncalls
    plain_equal = None
    if with_plain:
        plain_equal = {"answers": len(store),
                       "missing": len(set(store) - set(pstore)),
                       "differ": sum(not _same_answer(v, pstore[k])
                                     for k, v in store.items()
                                     if k in pstore)}
        plain_equal["ok"] = (plain_equal["missing"] == 0
                             and plain_equal["differ"] == 0)
    return {
        "d": spec.mesh_devices,
        "cards": [str(x) for x in (spec.mesh.distinct if spec.mesh
                                   else [home])],
        "geometry": geometry, "after": after, "index_sorted": index_sorted,
        "walls": walls,
        "point_isolated_ms": {"p50": iso[0], "p99": iso[1],
                              "n": len(iso_lat)},
        "point_mixed_ms": {"p50": mix[0], "p99": mix[1],
                           "n": len(mixed_point)},
        "p99_vs_isolated": mix[1] / iso[1],
        "bulk_mixed_ms": {"p50": blk_p[0], "p99": blk_p[1],
                          "n": len(mixed_bulk)},
        "steady_qps": steady_served / walls["steady_s"],
        "isolated_classified_point": iso_klass,
        "jit_retraces_delta": retrace_delta,
        "launch_signatures": {k: len(v) for k, v in signatures.items()},
        "inserts_per_s": LOOP_COMPACT_AT / insert_s,
        "compaction": comp, "gc_in_write_wave": gc_write,
        "insert_driver_allocs": insert_driver_allocs,
        "compacted_under_load": len(comp) == 1 and comp[0]["queued"] > 0,
        "busy": busy, "peaks": peaks,
        "peak_mem_bytes": {c: max(p[c] for p in peaks.values())
                           for c in next(iter(peaks.values()))},
        "exact": not bad, "wrong": bad[:5],
        "join_rejected": join_ok, "poisoned_failed_alone": poison_ok,
        "threaded_exact": threaded["ok"],
        "threaded_requests": threaded["requests"],
        "overload": {k: overload[k] for k in ("rejected", "late", "ok")},
        "tenants": tenants, "loop_stats": stats, "plain_equal": plain_equal,
        "answers": store, "raw": raw, "launches": launches, **kernels}


def phase_loop_shard(dev, rate) -> dict:
    """Phase 11a: the serving loop in front of a sharded table.  Alice's
    LOOP_ROWS-argument tenant (57,344 live rows, seed 11, paper keys as
    phase 11 makes them) with an unindexed column `w` beside `v`, as the
    plain tenant (a QueryServer over its Table and SortedIndex), and in
    SHARDS shards of LOOP_ROWS // SHARDS slots behind one
    ServeLoop(batch=8), run in three layouts: (a) unplaced, with the
    plain tenant registered beside it; (b) placed on `[cuda:0] * 4`;
    (c) placed on cuda:0-3 where four cards are visible, else recorded
    as skipped.  Each layout runs `_loop_shard_run`'s traffic.  Every
    answer equals the plaintext and, by (plan, epoch), the plain
    tenant's; (b)'s and (c)'s answers and raw scan values (sha256) equal
    (a)'s; per tenant, submitted = ok + rejected + shed + failed; no new
    launch signature in the steady mix; compaction ran under queued
    queries and left no old stack allocated; every kernel shape equal
    to plain, launches reconciled.  Point p99 mixed against isolated is
    printed, not gated."""
    import torch

    from repro_torch import db

    rows = LOOP_ROWS
    n_rows = rows - max(rows // 8, 4 * LOOP_COMPACT_AT)
    count = torch.cuda.device_count() if torch.device(dev).type == "cuda" \
        else 0
    t0 = time.perf_counter()
    alice = _loop_tenant(dev, "alice", 11, n_rows, rows, with_w=True)
    script = _loop_shard_script(alice)
    setup_s = time.perf_counter() - t0
    cuda = [torch.device("cuda", j) if count else torch.device(dev)
            for j in range(SHARDS)]
    layouts = [("unplaced", db.ShardSpec.create(SHARDS, use_mesh=False)),
               ("placed", db.ShardSpec.create(SHARDS,
                                              devices=[cuda[0]] * SHARDS))]
    if count >= SHARDS:
        layouts.append(("four_cards",
                        db.ShardSpec.create(SHARDS, devices=cuda)))
    runs = {}
    for name, spec in layouts:
        run = _loop_shard_run(alice, script, spec, rate,
                              with_plain=name == "unplaced")
        emit({"phase": "loop_shard_run", "layout": name,
              **{k: v for k, v in run.items()
                 if k not in ("answers", "raw")}})
        runs[name] = run
    flat = runs["unplaced"]
    same = {name: {"raw_equal": r["raw"] == flat["raw"],
                   "answers_equal": r["answers"].keys()
                   == flat["answers"].keys() and all(
                       _same_answer(r["answers"][k], flat["answers"][k])
                       for k in flat["answers"])}
            for name, r in runs.items() if name != "unplaced"}
    four = ({"cards": [str(c) for c in cuda]} if count >= SHARDS else
            {"skipped": f"{count} card(s) visible: layout (c) places the "
                        f"{SHARDS} shards on cuda:0-{SHARDS - 1}, which "
                        f"needs {SHARDS} cards"})

    def stale(r):
        """Bytes a card holds after compaction beyond the tenants'
        stacks, deltas and indexes (an old stack would be GiBs)."""
        return max((c["live_bytes"][k] - c["accounted_bytes"][k]
                    for c in r["compaction"] for k in c["live_bytes"]),
                   default=0)
    out = {
        "phase": "loop_shard", "profile": LOOP_PROFILE, "mode": "paper",
        "rows": n_rows, "shards": SHARDS, "slots": rows // SHARDS,
        "setup_s": setup_s, "plain_index_build_s": alice["index_build_s"],
        "plain_encrypt_s": alice["encrypt_s"],
        "raw_records": len(flat["raw"]), "layouts_equal": same,
        "four_cards": four,
        "runs": {name: {k: r[k] for k in (
            "d", "cards", "walls", "point_isolated_ms", "point_mixed_ms",
            "p99_vs_isolated", "bulk_mixed_ms", "steady_qps",
            "inserts_per_s", "compaction", "gc_in_write_wave",
            "insert_driver_allocs", "busy", "peak_mem_bytes",
            "exact", "plain_equal", "tenants", "launches",
            "launches_reconciled")} | {"stale_bytes": stale(r)}
            for name, r in runs.items()}}
    emit(out)
    for name, r in runs.items():
        require(r["index_sorted"], f"the ShardedIndex is not sorted ({name})")
        require(r["exact"], f"a sharded loop answer diverged from the "
                f"plaintext ({name}): {r['wrong']}")
        require(r["isolated_classified_point"],
                f"an isolated Eq on the indexed v ran as bulk ({name})")
        require(r["jit_retraces_delta"] == 0,
                f"{r['jit_retraces_delta']} new launch signatures in the "
                f"steady mix ({name}): {r['launch_signatures']}")
        require(r["compacted_under_load"],
                f"compaction did not run once under queued queries "
                f"({name}): {r['compaction']}")
        require(stale(r) < 2 ** 31, f"{stale(r)} bytes beyond the tenants' "
                f"stacks after compaction ({name})")
        require(r["join_rejected"], f"the join was not rejected at "
                f"admission with the counters unchanged ({name})")
        require(r["poisoned_failed_alone"],
                f"the poisoned plan did not fail alone ({name})")
        require(r["threaded_exact"], f"the always-on round answered wrong "
                f"({name})")
        require(r["overload"]["ok"], f"overload ({name}): {r['overload']}")
        require(all(t["ok"] for t in r["tenants"].values()),
                f"per-tenant counts do not reconcile ({name}): "
                f"{r['tenants']}")
        require(r["equal"], f"a kernel != plain at a shape of the sharded "
                f"loop ({name})")
        require(r["launches_reconciled"], f"launches {r['launches']} != "
                f"the recorded calls ({name})")
        require(all(r["launches"][k] > 0 for k in LOOP_SHARD_KERNELS),
                f"a kernel never launched on the sharded loop ({name}): "
                f"{r['launches']}")
        require(r["d"] == (1 if name == "unplaced" else SHARDS),
                f"layout {name} has d = {r['d']}")
    require(flat["plain_equal"]["ok"], f"sharded answers differ from, or "
            f"lack, the plain tenant's to the same plan: "
            f"{flat['plain_equal']}")
    for name, eq in same.items():
        require(eq["raw_equal"], f"raw scan values of {name} differ from "
                "the unplaced layout's")
        require(eq["answers_equal"], f"answers of {name} differ from the "
                "unplaced layout's")
    return out


# ---------------------------------------------------------------------------
# the LM serve path at full width, then the encrypted top-k over its scores
# ---------------------------------------------------------------------------

def record_mul_shapes() -> tuple:
    """Record every call of the two multiply wrappers until `stop()`:
    shapes maps ("key", a's shape, id of the key transform) or ("var",
    a's shape, b's shape) to [calls, the key transform and its pairs].
    A call counts once the kernel has returned, under a lock (the serving
    loop's client threads encrypt while its pump runs)."""
    import threading

    from repro_torch.kernels import ntt as NK
    inner_ntt, inner_var, shapes, lock = (NK.negacyclic_mul_ntt,
                                          NK.negacyclic_mul, {},
                                          threading.Lock())

    def key_mul(a, b_br, ring, b_shoup=None):
        res = inner_ntt(a, b_br, ring, b_shoup)
        with lock:
            ent = shapes.setdefault(("key", tuple(a.shape), id(b_br)),
                                    [0, b_br, b_shoup])
            ent[0] += int(a.numel() > 0)
        return res

    def var_mul(a, b, ring):
        res = inner_var(a, b, ring)
        with lock:
            ent = shapes.setdefault(("var", tuple(a.shape), tuple(b.shape)),
                                    [0, None, None])
            ent[0] += int(a.numel() > 0 and b.numel() > 0)
        return res

    def stop():
        NK.negacyclic_mul_ntt, NK.negacyclic_mul = inner_ntt, inner_var
    NK.negacyclic_mul_ntt, NK.negacyclic_mul = key_mul, var_mul
    return shapes, stop


def check_mul_shapes(ks, shapes: dict, seed: int, rate) -> dict:
    """Both multiplies against their plain versions at every shape a path
    gave them (`record_mul_shapes`), tolerance 0, on uniform operands of
    the recorded shapes (the key multiply against the path's own key
    transform); each timed by CUDA events beside its bound."""
    import torch
    from repro_torch.core import sampling
    from repro_torch.kernels import ntt as NK

    params, ring = ks.params, ks.ring
    K, n = params.num_towers, params.n
    gen = sampling.make_generator(seed, ks.device)
    eq, out = True, []
    for (kind, a_shape, b), (calls, br, pairs) in shapes.items():
        a = sampling.uniform_poly(params, gen, a_shape[:-2])
        rows = int(np.prod(a_shape[:-2]))
        if kind == "key":
            def kernel():
                return NK.negacyclic_mul_ntt(a, br, ring, pairs)

            def plain():
                return NK.negacyclic_mul_ntt_plain(a, br, ring)
            bound = mul_bound(rows, K, n, 1, rate, key_ntt=True)
        else:
            bb = sampling.uniform_poly(params, gen, b[:-2])

            def kernel():
                return NK.negacyclic_mul(a, bb, ring)

            def plain():
                return NK.negacyclic_mul_plain(a, bb, ring)
            bound = mul_bound(rows, K, n, int(np.prod(b[:-2])), rate,
                              key_ntt=False)
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        same = bool(torch.equal(got, want))
        eq &= same
        out.append({"kind": kind, "shape": list(a_shape), "calls": calls,
                    "equal": same, "max_abs_err": max_abs_err(got, want),
                    "ms": time_cuda(kernel, 5),
                    "plain_ms": time_cuda(plain, 1), **bound})
        del a, got, want
    torch.cuda.empty_cache()
    return {"tolerance": 0, "equal": eq, "shapes": out}


def _float_dataset(name: str, rows: int = 0) -> np.ndarray:
    """A dataset's CKKS floats on the CKKS_GRID lattice in [0, 1000]
    (benchmarks/db_engine.py::_float_dataset's preprocessing): the
    plaintext answers stay exact.  `rows` > 0 keeps the first rows."""
    from repro_torch.data import load_dataset
    raw = load_dataset(name, scheme="ckks")
    if rows:
        raw = raw[:rows]
    return np.round(raw / raw.max() * 4000.0) * CKKS_GRID


def _lattice(rng, n: int) -> np.ndarray:
    """run_ckks's aux column: uniform on [0, 50], on the lattice."""
    return np.round(rng.uniform(0, 50, n) / CKKS_GRID) * CKKS_GRID


def check_ntt_calls(calls: dict, launches: dict, rate) -> dict:
    """`ntt_br` against its plain version at every distinct call
    `record_calls(("ntt_br",))` recorded (`check_calls`), each timed by
    CUDA events beside its bound and beside the C = 1 kernel
    (`tools/ntt_c1.cu`), on the card that holds its operand, with the
    plan that card gives it."""
    import torch
    from repro_torch.kernels import ntt as NK
    checked = check_calls(calls, {k: launches[k] for k in
                                  ("ntt_br_fwd", "ntt_br_inv")})
    timed = []
    for n_calls, counter, _, arg in calls.values():
        x, ring, fwd = arg["x"], arg["ring"], arg["fwd"]
        K, n = x.shape[-2:]
        # a KeySet replica's transforms run on its own card: time there
        with (torch.cuda.device(x.device) if x.is_cuda
              else contextlib.nullcontext()):
            rows = int(np.prod(x.shape[:-2]))
            plan = (list(NK.plan(rows, K, n, *NK.card_shape(
                x.device.index), fwd=fwd)) if x.is_cuda else None)
            c1 = (kernel_variants().ntt_call(
                C1["lib"].hades_ntt_br_c1, x, ring, fwd) if x.is_cuda
                else None)
            # both in turns by device time too (graph replay below 64
            # MiB): 5 back-to-back calls by events time the host's path
            turns = (kernel_variants().time_turns(
                {"c1": c1, "planned": lambda: NK.ntt_br(x, ring, fwd=fwd)},
                16 * rows * K * n) if c1 else {})
            timed.append({
                "kernel": counter, "device": str(x.device),
                "shape": list(x.shape), "calls": n_calls, "plan": plan,
                "ms": time_cuda(lambda: NK.ntt_br(x, ring, fwd=fwd), 5),
                "c1_ms": time_cuda(c1, 5) if c1 else None, "turns": turns,
                "plain_ms": time_cuda(
                    lambda: NK.ntt_br_plain(x, ring, fwd=fwd), 1),
                **ntt_bound(int(np.prod(x.shape[:-2])), K, n, rate)})
    return {**checked, "timed": timed}


def _gadget_path_checks(ks, source, gshapes, mshapes, ncalls, launches, seed,
                       rate) -> dict:
    """The gadget Eval, both multiplies and ntt_br against their plain
    versions at every shape a gadget-mode path launched them at
    (tolerance 0, on rows of `source`), the calls reconciled with its
    launch counts (the paper Eval at 0)."""
    import torch
    gadget = check_gadget_shapes(ks, source, gshapes, seed, rate)
    muls = check_mul_shapes(ks, mshapes, seed + 1, rate)
    ntts = check_ntt_calls(ncalls, launches, rate)
    torch.cuda.empty_cache()
    g_calls = sum(s["calls"] * s["launches_per_call"]
                  for s in gadget["shapes"])
    m_calls = {k: sum(s["calls"] for s in muls["shapes"] if s["kind"] == k)
               for k in ("key", "var")}
    reconciled = (g_calls == launches["eval_coeff0_gadget"]
                  and m_calls["key"] == launches["negacyclic_mul_ntt"]
                  and m_calls["var"] == launches["negacyclic_mul"]
                  and ntts["launches_reconciled"]
                  and launches["eval_coeff0_paper"] == 0)
    return {"gadget_shapes": gadget, "mul_shapes": muls, "ntt_calls": ntts,
            "shapes_equal": gadget["equal"] and muls["equal"]
            and ntts["equal"], "launches_reconciled": reconciled}


def phase_ckks(dev, rate) -> dict:
    """Float columns through the engine at CKKS_PROFILE in gadget mode
    (`benchmarks/fig2_ckks.py` and `db_engine.py::run_ckks`'s traffic),
    every answer against numpy on the plaintext:

      1. fig2's micro-operations over CKKS_MICRO values: keygen, Enc
         Basic, Enc FAE, Cmp Basic and Cmp FAE (each sign checked);
      2. tables (a) bitcoin (1,085 rows) and (b) hg38's first CKKS_ROWS
         rows, each with `v` and run_ckks's lattice `aux`;
      3. `SortedIndex.build` on each `v` (sorted order checked);
      4. an ε-band Eq (ε = 2.5 grid steps, off the lattice), linear and
         indexed; 5. CKKS_RANGES Ranges with off-lattice bounds, linear
         and indexed; 6. And(Range(v), Eq(aux, ε = 1.5 steps)) + TopK(v,
         5); 4-6 on both tables;
      7. a QueryServer batch of 8 over (b)'s index: ε-band Eqs and
         Ranges, each with its own ε (so its own τ), each equal to its
         own `execute` and the plaintext;
      9. the ε-band sort-merge join of (b).v against (a).v (ε = 1.5
         steps, both indexed, the verify pass), pairs against the
         plaintext's {(i, j): |l_i - r_j| <= ε};
      8. then (a) is freed and (b) written: CKKS_INSERT inserts,
         CKKS_DELETE deletes, an ε-band Eq and a Range over base ∪
         delta (scan and indexed), compaction, the reads again.

    The join runs before the writes: after compaction (b) holds
    CKKS_ROWS + CKKS_INSERT rows, whose merge block (twice 32,768 rows,
    32 GiB, and the stage temporaries) would not fit beside the table.
    Then the gadget Eval, both multiplies and `ntt_br` against their
    plain versions at every shape the phase launched them at (tolerance
    0), the calls reconciled with the launch counts; walls, queries/s,
    inserts/s and the peak memory of each part.  Returns the record and
    what `phase_ckks_shard` replays: the keys, the data, every query with
    its truth and this phase's answer, the join's pairs and the writes."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import db, obs
    from repro_torch.core import compare as C
    from repro_torch.core import encrypt as E
    from repro_torch.core.ckks import eps_to_tau, equality_tolerance
    from repro_torch.core.keys import keygen
    from repro_torch.core.params import make_params
    from repro_torch.kernels import _build

    G = CKKS_GRID
    hp = make_params(CKKS_PROFILE, mode="gadget")
    vals = {"a": _float_dataset("bitcoin"),
            "b": _float_dataset("hg38", CKKS_ROWS)}
    rng = np.random.default_rng(SEED)
    aux = {k: _lattice(rng, len(v)) for k, v in vals.items()}
    seeds = iter(range(7000, 8000))
    walls, peaks, live, ok = {}, {}, {}, {}
    # what the sharded phase replays: the queries, their truths and this
    # phase's unsharded answers (host arrays)
    base = {"vals": vals, "aux": aux, "reads": {"a": [], "b": []}}

    def sync_s(t0):
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def peak(name):
        """The peak since the last call, and what is still allocated."""
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated()
        live[name] = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()

    def fenc(v):
        return E.encrypt(ks, float(v), next(seeds))

    def same(res, want):
        return bool(np.array_equal(res.mask, want))

    def draw_range(v):
        lo, hi = np.sort(rng.choice(v, 2, replace=False))
        return float(lo) - G / 2, float(hi) + G / 2

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    gshapes, gstop = record_gadget_shapes()
    mshapes, mstop = record_mul_shapes()
    ncalls, nstop = record_calls(("ntt_br",))
    try:
        # ---- 1. fig2's micro-operations ---------------------------------
        t0 = time.perf_counter()
        ks = keygen(hp, SEED + 60, device=dev)
        walls["keygen_s"] = sync_s(t0)
        m = np.random.default_rng(8).uniform(0, 1e6, CKKS_MICRO)
        mt = torch.as_tensor(m, device=dev)
        t0 = time.perf_counter()
        ct_a = E.encrypt(ks, mt, SEED + 61)
        walls["enc_basic_s"] = sync_s(t0)
        ct_b = E.encrypt(ks, torch.roll(mt, 1), SEED + 62)
        t0 = time.perf_counter()
        fa = E.encrypt_fae(ks, mt, SEED + 63)
        walls["enc_fae_s"] = sync_s(t0)
        fb = E.encrypt_fae(ks, torch.roll(mt, 1), SEED + 64)
        t0 = time.perf_counter()
        cmp_b = C.compare(ks, ct_a, ct_b).cpu().numpy()
        walls["cmp_basic_s"] = sync_s(t0)
        t0 = time.perf_counter()
        cmp_f = C.compare_fae(ks, fa, fb).cpu().numpy()
        walls["cmp_fae_s"] = sync_s(t0)
        ok["micro"] = bool(np.array_equal(cmp_b, np.sign(m - np.roll(m, 1)))
                           and np.array_equal(cmp_f, m > np.roll(m, 1)))
        del ct_a, ct_b, fa, fb, mt
        peak("micro")

        # ---- 2-3. tables and their indexes ------------------------------
        tables, idx = {}, {}
        for k in ("a", "b"):
            t0 = time.perf_counter()
            tables[k] = db.Table.from_arrays(
                ks, f"ckks_{k}", {"v": vals[k], "aux": aux[k]},
                SEED + 65 + (k == "b"))
            walls[f"encrypt_{k}_s"] = sync_s(t0)
        for k in ("a", "b"):
            with (profile(activities=[ProfilerActivity.CPU,
                                      ProfilerActivity.CUDA])
                  if k == "b" else contextlib.nullcontext()) as prof:
                t0 = time.perf_counter()
                idx[k] = db.SortedIndex.build(ks, tables[k], "v")
                walls[f"index_{k}_s"] = sync_s(t0)
            ok[f"index_{k}"] = bool(np.array_equal(
                vals[k][idx[k].perm], np.sort(vals[k])))
        build_dev = _device_summary(prof, walls["index_b_s"])
        del prof
        peak("index_build")

        # ---- 4-6. ε-band Eq, Ranges, And + TopK on both tables ----------
        for k in ("a", "b"):
            v, t, ix = vals[k], tables[k], {"v": idx[k]}
            n = len(v)
            target, eps = float(v[n // 3]), 2 * G + G / 2
            q = db.Eq("v", fenc(target), eps=eps)
            want = np.abs(v - target) <= eps
            t0 = time.perf_counter()
            lin = db.execute(ks, t, q)
            walls[f"eq_linear_{k}_s"] = sync_s(t0)
            t0 = time.perf_counter()
            ind = db.execute(ks, t, q, indexes=ix)
            walls[f"eq_indexed_{k}_s"] = sync_s(t0)
            ok[f"eq_{k}"] = same(lin, want) and same(ind, want)
            base["reads"][k].append(("eq", q, want, lin.mask, lin.row_ids))
            ranges = [draw_range(v) for _ in range(CKKS_RANGES)]
            plans = [db.Range("v", fenc(lo), fenc(hi)) for lo, hi in ranges]
            for name, use in (("linear", None), ("indexed", ix)):
                t0 = time.perf_counter()
                res = [db.execute(ks, t, q, indexes=use) for q in plans]
                walls[f"range_{name}_{k}_s"] = sync_s(t0) / CKKS_RANGES
                ok[f"range_{name}_{k}"] = all(
                    same(r, (v >= lo) & (v <= hi))
                    for r, (lo, hi) in zip(res, ranges))
            base["reads"][k] += [
                (f"range{i}", q, (v >= lo) & (v <= hi), r.mask, r.row_ids)
                for i, (q, r, (lo, hi)) in enumerate(zip(plans, res,
                                                         ranges))]
            lo = float(np.percentile(v, 30)) - G / 2
            hi = float(np.percentile(v, 70)) + G / 2
            eq_v, band = float(aux[k][n // 2]), G + G / 2
            query = db.Query(where=db.And(
                db.Range("v", fenc(lo), fenc(hi)),
                db.Eq("aux", fenc(eq_v), eps=band)), top_k=db.TopK("v", 5))
            t0 = time.perf_counter()
            res = db.execute(ks, t, query)
            walls[f"and_topk_{k}_s"] = sync_s(t0)
            want = (v >= lo) & (v <= hi) & (np.abs(aux[k] - eq_v) <= band)
            ok[f"and_topk_{k}"] = same(res, want) and (
                v[res.row_ids].tolist()
                == sorted(v[want].tolist(), reverse=True)[:5])
            base["reads"][k].append(("and_topk", query, want, res.mask,
                                     res.row_ids))
        # the loops' last index dict would keep (b)'s index alive through
        # compaction, beside the merged one
        del ix, use
        peak("queries")

        # ---- 7. a batch of 8 over (b)'s index, each with its own τ ------
        v = vals["b"]
        reqs = []
        for e in (G + G / 2, 2 * G + G / 2, 3 * G + G / 2, 4 * G + G / 2):
            x = float(rng.choice(v))
            reqs.append((db.Eq("v", fenc(x), eps=e), np.abs(v - x) <= e))
        for e in (None, G, 2 * G, 3 * G):
            lo, hi = draw_range(v)
            w = e or 0.0
            reqs.append((db.Range("v", fenc(lo), fenc(hi), eps=e),
                         (v > lo - w) & (v < hi + w)))
        taus = sorted({hp.tau if q.eps is None else eps_to_tau(hp, q.eps)
                       for q, _ in reqs})
        server = db.QueryServer(ks, tables["b"], indexes={"v": idx["b"]},
                                batch=len(reqs))
        qids = [server.submit(q) for q, _ in reqs]
        t0 = time.perf_counter()
        got = server.run()
        walls["batch_s"] = sync_s(t0)
        own = [db.execute(ks, tables["b"], q, indexes={"v": idx["b"]})
               for q, _ in reqs]
        ok["batch"] = all(
            same(got[i], want) and np.array_equal(got[i].row_ids, o.row_ids)
            for i, (_, want), o in zip(qids, reqs, own))
        bs = server.batch_log[0]
        batch = {"queries": bs.queries, "eval_calls": bs.eval_calls,
                 "index_compares": bs.index_compares}
        base["batch"] = [(q, want, got[i].mask, got[i].row_ids)
                         for i, (q, want) in zip(qids, reqs)]

        # ---- 9. the ε-band sort-merge join of (b).v against (a).v -------
        band = G + G / 2
        with obs.tracing() as tracer:
            t0 = time.perf_counter()
            jres = db.execute_join(
                ks, tables["b"], tables["a"],
                db.Join(None, None, on="v", eps=band), strategy="sort_merge",
                left_indexes={"v": idx["b"]}, right_indexes={"v": idx["a"]})
            walls["join_s"] = sync_s(t0)
        want_pairs = np.argwhere(
            np.abs(vals["b"][:, None] - vals["a"][None, :]) <= band)
        ok["join"] = bool(np.array_equal(jres.pairs, want_pairs)
                          and jres.stats.verify_compares > 0)
        js = jres.stats
        base["join"] = {"band": band, "pairs": jres.pairs,
                        "want": want_pairs}
        join = {"pairs": len(jres), "eval_calls": js.eval_calls,
                "merge_compares": js.merge_compares,
                "adjacency_compares": js.adjacency_compares,
                "verify_compares": js.verify_compares,
                "span_ms": _span_ms(tracer)}
        del jres
        peak("join")
        # the rows the kernel checks draw from: 256 of (a)'s rows
        col = tables["a"].columns["v"]
        source = E.Ciphertext(col.c0[:256].clone(), col.c1[:256].clone())
        del col
        del tables["a"], idx["a"], server, got, own
        gc.collect()
        torch.cuda.empty_cache()

        # ---- 8. writes on (b): inserts, deletes, union reads, compact ---
        tb, ix = tables.pop("b"), {"v": idx.pop("b")}
        n = len(v)
        ins = {"v": rng.choice(v, CKKS_INSERT),
               "aux": _lattice(rng, CKKS_INSERT)}
        t0 = time.perf_counter()
        new_ids = tb.insert(ks, ins, SEED + 67)
        walls["insert_s"] = sync_s(t0)
        all_v = np.concatenate([v, ins["v"]])
        alive = np.ones(len(all_v), bool)
        dead = rng.choice(len(all_v), CKKS_DELETE, replace=False)
        ok["insert_delete"] = bool(
            np.array_equal(new_ids, np.arange(n, n + CKKS_INSERT))
            and tb.delete(dead) == CKKS_DELETE)
        alive[dead] = False
        target, eq_eps = float(ins["v"][CKKS_INSERT // 2]), 2 * G + G / 2
        lo, hi = draw_range(all_v)
        q_eq = db.Eq("v", fenc(target), eps=eq_eps)
        q_rg = db.Range("v", fenc(lo), fenc(hi))
        want_eq = (np.abs(all_v - target) <= eq_eps) & alive
        want_rg = (all_v >= lo) & (all_v <= hi) & alive
        base["writes"] = {"insert": ins, "dead": dead, "q_eq": q_eq,
                          "q_rg": q_rg, "want_eq": want_eq,
                          "want_rg": want_rg, "masks": {}}

        def union_reads(tag):
            for name, use in (("scan", None), ("indexed", ix)):
                t0 = time.perf_counter()
                r_eq = db.execute(ks, tb, q_eq, indexes=use)
                r_rg = db.execute(ks, tb, q_rg, indexes=use)
                walls[f"{tag}_{name}_s"] = sync_s(t0) / 2
                ok[f"{tag}_{name}"] = (same(r_eq, want_eq)
                                       and same(r_rg, want_rg))
                base["writes"]["masks"][f"{tag}_{name}"] = (r_eq.mask,
                                                            r_rg.mask)
        union_reads("union")
        gc.collect()
        peak("union_reads")
        t0 = time.perf_counter()
        cstats = db.compact(ks, tb, ix)
        walls["compact_s"] = sync_s(t0)
        peak("compact")
        ok["compact"] = bool(
            not tb.has_delta
            and np.array_equal(all_v[ix["v"].perm], np.sort(all_v))
            and 0 < cstats.merge_compares < cstats.rebuild_compares)
        union_reads("post_compact")
        peak("post_compact")
        after = {"b_after_compaction": tb.n_rows,
                 "b_padded_after_compaction": tb.n_padded}
    finally:
        gstop()
        mstop()
        nstop()
    launches = dict(_build.LAUNCHES)
    del tables, idx, tb, ix
    gc.collect()
    torch.cuda.empty_cache()

    kern = _gadget_path_checks(ks, source, gshapes, mshapes, ncalls,
                               launches, SEED + 68, rate)
    del source, ncalls
    gadget, muls, ntts, reconciled = (kern[k] for k in (
        "gadget_shapes", "mul_shapes", "ntt_calls", "launches_reconciled"))
    exact = all(ok.values())
    out = {
        "phase": "ckks", "profile": CKKS_PROFILE, "mode": "gadget",
        "n": hp.n, "towers": hp.num_towers, "grid": G,
        "tolerance": equality_tolerance(hp), "taus": taus,
        "max_operand": hp.max_operand,
        "rows": {"a": len(vals["a"]), "b": len(vals["b"]),
                 "b_inserted": CKKS_INSERT, "b_deleted": CKKS_DELETE,
                 **after},
        "row_bytes": 2 * 8 * hp.num_towers * hp.n,
        "exact": exact, "checks": ok, "walls": walls,
        "queries_per_s": len(reqs) / walls["batch_s"],
        "inserts_per_s": CKKS_INSERT / walls["insert_s"],
        "batch": batch, "join": join,
        "compact": {"merge_compares": cstats.merge_compares,
                    "rebuild_compares": cstats.rebuild_compares,
                    "rounds": cstats.merge_rounds},
        "index_build_device": build_dev,
        "peak_mem_bytes": max(peaks.values()), "peaks": peaks,
        "live_bytes": live,
        "launches": launches, "launches_reconciled": reconciled,
        "gadget_shapes": gadget, "mul_shapes": muls, "ntt_calls": ntts,
    }
    emit(out)
    require(exact, f"a float answer diverged from the plaintext: {ok}")
    require(gadget["equal"] and muls["equal"] and ntts["equal"],
            "a kernel != plain at a float-path shape")
    require(reconciled, f"launches {launches} != the recorded calls")
    require(all(launches[k] > 0 for k in CKKS_KERNELS),
            f"a kernel never launched on the float path: {launches}")
    return out, {**base, "ks": ks}


def _shard_index_sorted(v: np.ndarray, st, ix) -> bool:
    """Each shard's index run of a ShardedTable ascends over its rows'
    plaintext, and the runs cover every row id once."""
    runs = [st.global_ids(s)[sh.perm] for s, sh in enumerate(ix.shards)]
    return bool(all(np.all(np.diff(v[g]) >= 0) for g in runs)
                and np.array_equal(np.sort(np.concatenate(runs)),
                                   np.arange(len(v))))


def _ckks_loop(ks, spec, base, walls, ok, sync_s, held) -> dict:
    """Phase 11c's float tenant behind a ServeLoop: (b) encrypted again
    into SHARDS shards under `spec` (the seed of `_ckks_shard_run`'s
    (b): the same ciphertexts), its ShardedIndex on `v`, a
    ShardedQueryServer with `compact_threshold` = CKKS_INSERT, then
    through the loop the float phase's batch (ε-band Eqs and Ranges,
    each its own τ a lane) and its reads of (b) (an ε-band Eq and
    Ranges as points, the And + TopK 5 as bulk), then its CKKS_INSERT
    inserts as one chunk (compaction crosses the threshold with the
    rest queued), its deletes and its two reads after them.  Each
    answer is held (`held`) to the plaintext and the float phase's
    unsharded answer; walls, the compaction's, and what is queued
    behind it go in the record."""
    import torch

    from repro_torch import db
    from repro_torch.db.serve_loop import BULK, POINT, ServeLoop
    v, w = base["vals"]["b"], base["writes"]
    t0 = time.perf_counter()
    tb = db.ShardedTable.from_arrays(ks, "ckks_b", {
        "v": v, "aux": base["aux"]["b"]}, SEED + 166, spec=spec)
    walls["loop_encrypt_s"] = sync_s(t0)
    t0 = time.perf_counter()
    idx = db.ShardedIndex.build(ks, tb, "v")
    walls["loop_index_s"] = sync_s(t0)
    ok["loop_index"] = _shard_index_sorted(v, tb, idx)
    server = db.ShardedQueryServer(ks, tb, indexes={"v": idx}, batch=8,
                                   compact_threshold=CKKS_INSERT)
    del idx
    loop = ServeLoop(batch=8)
    loop.register("ckks_b", server)
    traffic = _Traffic(loop)
    comp = []
    inner_compact = server.compact

    def compact():
        sync_s(0.0)                  # the insert before it, finished
        t0 = time.perf_counter()
        stats = inner_compact()
        comp.append({"s": sync_s(t0), "queued": loop.queue_depth(),
                     "n_delta": stats.n_delta,
                     "live_bytes": torch.cuda.memory_allocated(ks.device),
                     "block_after": tb.n_padded_per_shard})
        return stats
    server.compact = compact
    inner_insert, insert = tb.insert, {}

    def timed_insert(*args, **kw):
        """The table's insert between two synchronizes, and the
        allocator's `cudaMalloc` calls during it."""
        sync_s(0.0)
        a0, t0 = _device_allocs(), time.perf_counter()
        ids = inner_insert(*args, **kw)
        insert.update(s=sync_s(t0), allocs=_device_allocs() - a0)
        return ids
    tb.insert = timed_insert

    # ---- reads: points by the fan-out index, the And + TopK as bulk ------
    plans = [(q, want, m0, r0, None) for q, want, m0, r0 in base["batch"]]
    plans += [(q, want, m0, r0, v if name == "and_topk" else None)
              for name, q, want, m0, r0 in base["reads"]["b"]]
    t0 = time.perf_counter()
    tks = [traffic.submit("alice", "ckks_b", q,
                          lambda r, a=(want, m0, r0, vv): held(r, *a))
           for q, want, m0, r0, vv in plans]
    res = traffic.drain()
    walls["loop_reads_s"] = sync_s(t0)
    ok["loop_classes"] = [res[t].klass for t in tks] == [
        BULK if vv is not None else POINT for *_, vv in plans]

    # ---- one insert chunk and the deletes, then reads behind them -------
    n = len(v)
    t0 = time.perf_counter()
    traffic.write("insert", "bob", "ckks_b", w["insert"], SEED + 167,
                  check=lambda r: np.array_equal(
                      r.row_ids, np.arange(n, n + CKKS_INSERT)))
    traffic.write("delete", "bob", "ckks_b", w["dead"],
                  check=lambda r: r.deleted == CKKS_DELETE)
    m_eq, m_rg = w["masks"]["post_compact_indexed"]
    for q, want, m0 in ((w["q_eq"], w["want_eq"], m_eq),
                        (w["q_rg"], w["want_rg"], m_rg)):
        traffic.submit("alice", "ckks_b", q,
                       lambda r, a=(want, m0, np.nonzero(m0)[0]):
                       held(r, *a))
    res = traffic.drain()
    walls["loop_writes_s"] = sync_s(t0)
    walls["loop_insert_s"] = insert["s"]
    ok["loop_served"] = not traffic.bad
    ok["loop_compacted_under_load"] = (len(comp) == 1
                                       and comp[0]["queued"] > 0
                                       and not tb.has_delta)
    out = {"requests": len(plans) + 4, "compaction": comp,
           "inserts_per_s": CKKS_INSERT / insert["s"],
           "insert_driver_allocs": insert["allocs"],
           "loop_stats": dict(vars(loop.stats)),
           "tenants": traffic.reconciled(), "wrong": traffic.bad[:5]}
    del tb, server, loop, traffic
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _ckks_shard_run(ks, spec, base, rate) -> dict:
    """One layout of `phase_ckks_shard`: the float phase's tables
    encrypted straight into SHARDS shards under `spec` (the same seeds
    in every layout, so the same ciphertexts), their ShardedIndexes, the
    float phase's reads (linear and indexed), its batch through a
    ShardedQueryServer, the ε-band sort-merge join and a nested
    cross-check, then (a) freed and (b) written and compacted, with
    every launch count zeroed just before and read just after.  Every
    answer is held against the plaintext and the float phase's
    unsharded answer; every raw scan, grid and verify value is recorded
    (sha256) for the placed run's comparison; then each kernel against
    its plain version at every shape this run gave it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import db, obs
    from repro_torch.core.ckks import eps_to_tau
    from repro_torch.db import join as J
    from repro_torch.db.shard import executor as SX
    from repro_torch.db.shard import join as SJ
    from repro_torch.kernels import _build

    vals, aux, hp = base["vals"], base["aux"], ks.params
    count = torch.cuda.device_count()
    walls, peaks, live, ok, devs, answers = {}, {}, {}, {}, {}, []

    def sync_s(t0):
        for c in range(count):
            torch.cuda.synchronize(c)
        return time.perf_counter() - t0

    def peak(part):
        """Each card's peak since the last part (then reset), and what
        is still allocated."""
        peaks[part], live[part] = {}, {}
        for c in range(count):
            torch.cuda.synchronize(c)
            peaks[part][f"cuda:{c}"] = torch.cuda.max_memory_allocated(c)
            live[part][f"cuda:{c}"] = torch.cuda.memory_allocated(c)
            torch.cuda.reset_peak_memory_stats(c)

    def held(res, want, mask0, rows0, v=None):
        """The answer against the truth and the unsharded answer (a
        TopK's rows by their values: ties may rank either way)."""
        answers.extend([res.mask, res.row_ids])
        rows_ok = (np.array_equal(v[res.row_ids], v[rows0]) if v is not None
                   else np.array_equal(res.row_ids, rows0))
        return bool(np.array_equal(res.mask, want)
                    and np.array_equal(res.mask, mask0) and rows_ok)

    def profiled():
        return profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])

    gc.collect()
    torch.cuda.empty_cache()
    for c in range(count):
        torch.cuda.reset_peak_memory_stats(c)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    gshapes, gstop = record_gadget_shapes()
    mshapes, mstop = record_mul_shapes()
    ncalls, nstop = record_calls(("ntt_br",))
    raws = {kind: record_raw(mod, fn) for kind, (mod, fn) in (
        ("scan", (SX, "sharded_fused_eval")),
        ("grid", (SJ, "sharded_pair_eval")),
        ("verify", (J, "_class_values")))}
    t_run = time.perf_counter()
    try:
        # ---- the tables and their ShardedIndexes -------------------------
        tables, idx = {}, {}
        for k in ("a", "b"):
            t0 = time.perf_counter()
            tables[k] = db.ShardedTable.from_arrays(
                ks, f"ckks_{k}", {"v": vals[k], "aux": aux[k]},
                SEED + 165 + (k == "b"), spec=spec)
            walls[f"encrypt_{k}_s"] = sync_s(t0)
        geometry = {k: {"shard_rows": t.shard_rows.tolist(),
                        "block": t.n_padded_per_shard,
                        "slabs": t.columns["v"].c0.num_slabs}
                    for k, t in tables.items()}
        peak("encrypt")
        for k in ("a", "b"):
            with profiled() if k == "b" else contextlib.nullcontext() as prof:
                t0 = time.perf_counter()
                idx[k] = db.ShardedIndex.build(ks, tables[k], "v")
                walls[f"index_{k}_s"] = sync_s(t0)
            ok[f"index_{k}"] = _shard_index_sorted(vals[k], tables[k], idx[k])
        build_compares = {k: ix.build_compares for k, ix in idx.items()}
        devs["index_build_b"] = _device_summary(prof, walls["index_b_s"])
        del prof
        peak("index_build")

        # ---- the float phase's reads, linear and through the index ------
        for k in ("a", "b"):
            for name, q, want, mask0, rows0 in base["reads"][k]:
                kind = name.rstrip("0123456789")
                for how, use in (("linear", None), ("indexed", {"v": idx[k]})):
                    t0 = time.perf_counter()
                    res = db.execute(ks, tables[k], q, indexes=use)
                    key = f"{kind}_{how}_{k}_s"
                    walls[key] = walls.get(key, 0.0) + sync_s(t0) / (
                        CKKS_RANGES if kind == "range" else 1)
                    ok[f"{kind}_{how}_{k}"] = ok.get(
                        f"{kind}_{how}_{k}", True) and held(
                            res, want, mask0, rows0,
                            vals[k] if kind == "and_topk" else None)
        # the loop's last index dict would keep (b)'s index alive through
        # compaction, beside the merged one
        del use, res
        peak("queries")

        # ---- the batch of 8 over (b)'s index, each with its own τ --------
        server = db.ShardedQueryServer(ks, tables["b"],
                                       indexes={"v": idx["b"]},
                                       batch=len(base["batch"]))
        qids = [server.submit(q) for q, *_ in base["batch"]]
        t0 = time.perf_counter()
        got = server.run()
        walls["batch_s"] = sync_s(t0)
        ok["batch"] = all(held(got[i], want, m0, r0) for i, (_, want, m0, r0)
                          in zip(qids, base["batch"]))
        bs = server.batch_log[0]
        batch = {f: getattr(bs, f) for f in (
            "queries", "shards", "eval_calls", "scan_compares",
            "index_compares", "merge_compares")}
        batch["taus"] = len({hp.tau if q.eps is None
                             else eps_to_tau(hp, q.eps)
                             for q, *_ in base["batch"]})
        del server, got
        peak("batch")

        # ---- the ε-band sort-merge join (b).v x (a).v, then nested ------
        jb = base["join"]
        band_join = db.Join(None, None, on="v", eps=jb["band"])
        with obs.tracing() as tracer, profiled() as prof:
            t0 = time.perf_counter()
            jres = db.execute_join(
                ks, tables["b"], tables["a"], band_join,
                strategy="sort_merge", left_indexes={"v": idx["b"]},
                right_indexes={"v": idx["a"]})
            walls["join_s"] = sync_s(t0)
        devs["join"] = _device_summary(prof, walls["join_s"])
        del prof
        pairs, js = jres.pairs, jres.stats
        answers.append(pairs)
        ok["join"] = bool(np.array_equal(pairs, jb["want"])
                          and np.array_equal(pairs, jb["pairs"])
                          and js.verify_compares > 0)
        join = {"pairs": len(pairs), "shards": list(js.shards),
                "eval_calls": js.eval_calls,
                "merge_compares": js.merge_compares,
                "adjacency_compares": js.adjacency_compares,
                "verify_compares": js.verify_compares,
                "build_compares": js.build_compares,
                "span_ms": _span_ms(tracer)}
        del jres, tracer
        peak("join")
        cut = CKKS_SHARD_CUT
        t0 = time.perf_counter()
        scut = db.ShardedTable.from_table(ks, db.Table.from_ciphertexts(
            "ckks_b_cut", {"v": tables["b"].gather_global(
                "v", np.arange(cut))}, cut), spec=spec)
        nres = db.execute_join(ks, scut, tables["a"], band_join,
                               strategy="nested")
        walls["nested_cut_s"] = sync_s(t0)
        answers.append(nres.pairs)
        ok["nested_cut"] = bool(
            np.array_equal(nres.pairs, pairs[pairs[:, 0] < cut])
            and np.array_equal(nres.pairs, np.argwhere(np.abs(
                vals["b"][:cut, None] - vals["a"][None, :]) <= jb["band"])))
        join["nested_cut"] = {"rows": [cut, len(vals["a"])],
                              "pairs": len(nres.pairs),
                              "eval_calls": nres.stats.eval_calls,
                              "pair_compares": nres.stats.pair_compares}
        del scut, nres
        peak("nested_cut")
        # the rows the kernel checks draw from: 256 of (a)'s rows
        source = tables["a"].gather_global("v", np.arange(256))
        del tables["a"], idx["a"]
        gc.collect()
        torch.cuda.empty_cache()

        # ---- writes on (b): inserts, deletes, union reads, compact -------
        w = base["writes"]
        tb, ix = tables.pop("b"), {"v": idx.pop("b")}
        n = len(vals["b"])
        all_v = np.concatenate([vals["b"], w["insert"]["v"]])
        routed = tb.route_counts(CKKS_INSERT).tolist()
        a0, t0 = _device_allocs(), time.perf_counter()
        new_ids = tb.insert(ks, w["insert"], SEED + 167)
        walls["insert_s"] = sync_s(t0)
        insert_allocs = {"direct": _device_allocs() - a0}
        ok["insert_delete"] = bool(
            np.array_equal(new_ids, np.arange(n, n + CKKS_INSERT))
            and tb.delete(w["dead"]) == CKKS_DELETE)
        delta_block = tb.delta_block

        def union_reads(tag):
            for name, use in (("scan", None), ("indexed", ix)):
                t0 = time.perf_counter()
                r_eq = db.execute(ks, tb, w["q_eq"], indexes=use)
                r_rg = db.execute(ks, tb, w["q_rg"], indexes=use)
                walls[f"{tag}_{name}_s"] = sync_s(t0) / 2
                m_eq, m_rg = w["masks"][f"{tag}_{name}"]
                ok[f"{tag}_{name}"] = (
                    held(r_eq, w["want_eq"], m_eq, np.nonzero(m_eq)[0])
                    and held(r_rg, w["want_rg"], m_rg, np.nonzero(m_rg)[0]))
        union_reads("union")
        gc.collect()
        peak("union_reads")
        t0 = time.perf_counter()
        cstats = db.compact(ks, tb, ix)
        walls["compact_s"] = sync_s(t0)
        peak("compact")
        ok["compact"] = bool(
            not tb.has_delta and _shard_index_sorted(all_v, tb, ix["v"])
            and 0 < cstats.merge_compares < cstats.rebuild_compares)
        union_reads("post_compact")
        peak("post_compact")
        after = {"shard_rows": tb.shard_rows.tolist(),
                 "block": tb.n_padded_per_shard}
        del tb, ix, tables, idx
        gc.collect()
        torch.cuda.empty_cache()
        served = _ckks_loop(ks, spec, base, walls, ok, sync_s, held)
        insert_allocs["loop"] = served.pop("insert_driver_allocs")
        peak("loop")
        launches = dict(_build.LAUNCHES)
        walls["run_s"] = sync_s(t_run)
    finally:
        gstop()
        mstop()
        nstop()
        walls["raw_hash_s"] = sum(stop() for _, stop in raws.values())
    gc.collect()
    torch.cuda.empty_cache()

    kern = _gadget_path_checks(ks, source, gshapes, mshapes, ncalls,
                               launches, SEED + 168, rate)
    del source, ncalls
    gadget, muls, ntts, reconciled = (kern[k] for k in (
        "gadget_shapes", "mul_shapes", "ntt_calls", "launches_reconciled"))
    return {
        "d": spec.mesh_devices,
        "cards": [str(x) for x in (spec.mesh.distinct if spec.mesh
                                   else [ks.device])],
        "geometry": geometry, "b_after_compaction": after,
        "routed": routed, "delta_block": delta_block,
        "insert_driver_allocs": insert_allocs,
        "exact": all(ok.values()), "checks": ok, "walls": walls,
        "queries_per_s": len(base["batch"]) / walls["batch_s"],
        "inserts_per_s": CKKS_INSERT / walls["insert_s"],
        "index_build_compares": build_compares, "batch": batch,
        "join": join, "loop": served,
        "compact": {"merge_compares": cstats.merge_compares,
                    "rebuild_compares": cstats.rebuild_compares,
                    "rounds": cstats.merge_rounds},
        "devices": devs, "peaks": peaks, "live_bytes": live,
        "peak_mem_bytes": {c: max(p[c] for p in peaks.values())
                           for c in next(iter(peaks.values()))},
        "raw": {kind: recs for kind, (recs, _) in raws.items()},
        "answers": answers,
        "launches": launches, "launches_reconciled": reconciled,
        "gadget_shapes": gadget, "mul_shapes": muls, "ntt_calls": ntts}


def phase_ckks_shard(base, rate) -> dict:
    """Float columns on ShardedTables at CKKS_PROFILE (gadget mode), on
    the float phase's keys and data (`base` from `phase_ckks`, whose
    tables are freed): (a) in SHARDS shards of 512-slot blocks, (b) in
    SHARDS of 4,096 (v and aux, 16 GiB on the card), run first unplaced
    (`ShardSpec.create(SHARDS, use_mesh=False)`) and then placed on
    SHARDS positions over the cards (`[cuda:0] * 4` on one card: four
    slabs; cuda:0-3 on four), each run `_ckks_shard_run`'s traffic: the
    ShardedIndex builds, the ε-band Eq, the Ranges and And + TopK
    (linear and indexed) on both, a ShardedQueryServer batch of 8 with
    its own τ a lane, the ε-band sort-merge join of (b).v against (a).v
    with its verify pass and a nested cross-check on (b)'s first
    CKKS_SHARD_CUT rows, then on (b) CKKS_INSERT inserts routed to the
    shards, CKKS_DELETE deletes, union reads (scan and indexed),
    compaction and the reads again.  Every answer equals the plaintext
    and the float phase's unsharded answer; the placed run's raw scan,
    grid and verify values equal the unplaced run's (sha256) and so do
    its answers; every kernel shape equals its plain version, launches
    reconciled (the paper Eval at 0)."""
    import torch

    from repro_torch import db

    ks = base["ks"]
    home = ks.device
    count = torch.cuda.device_count()
    positions = [torch.device("cuda", j % count) if home.type == "cuda"
                 else home for j in range(SHARDS)]
    t0 = time.perf_counter()
    runs = {}
    for layout, spec in (
            ("unplaced", db.ShardSpec.create(SHARDS, use_mesh=False)),
            ("placed", db.ShardSpec.create(SHARDS, devices=positions))):
        run = _ckks_shard_run(ks, spec, base, rate)
        emit({"phase": "ckks_shard_run", "layout": layout,
              **{k: v for k, v in run.items()
                 if k not in ("answers", "raw")}})
        runs[layout] = run
    flat, placed = runs["unplaced"], runs["placed"]
    raw_equal = placed["raw"] == flat["raw"]
    answers_equal = (len(placed["answers"]) == len(flat["answers"])
                     and all(np.array_equal(x, y) for x, y in
                             zip(placed["answers"], flat["answers"])))
    distinct = sorted({str(x) for x in positions})
    four = ({"cards": distinct} if len(distinct) >= SHARDS else
            {"skipped": f"{count} card(s) visible: the placed run's "
                        f"{SHARDS} mesh positions lie on {distinct}; a run "
                        f"over cuda:0-{SHARDS - 1} needs {SHARDS} cards"})
    out = {
        "phase": "ckks_shard", "profile": CKKS_PROFILE, "mode": "gadget",
        "shards": SHARDS, "n": ks.params.n,
        "rows": {"a": len(base["vals"]["a"]), "b": len(base["vals"]["b"]),
                 "b_inserted": CKKS_INSERT, "b_deleted": CKKS_DELETE,
                 "nested_cut": CKKS_SHARD_CUT},
        "exact": flat["exact"] and placed["exact"],
        "raw_equal": raw_equal, "answers_equal": answers_equal,
        "raw_records": {k: len(v) for k, v in flat["raw"].items()},
        "four_cards": four, "seconds": time.perf_counter() - t0,
        "runs": {layout: {k: r[k] for k in (
            "d", "cards", "exact", "checks", "walls", "queries_per_s",
            "inserts_per_s", "join", "compact", "loop", "devices",
            "peak_mem_bytes", "peaks", "live_bytes", "launches",
            "launches_reconciled")}
            | {"shapes_equal": r["gadget_shapes"]["equal"]
               and r["mul_shapes"]["equal"] and r["ntt_calls"]["equal"]}
            for layout, r in runs.items()}}
    emit(out)
    for layout, r in runs.items():
        require(r["exact"], f"a sharded float answer diverged from the "
                f"plaintext or the unsharded answer ({layout}): "
                f"{r['checks']}")
        require(r["gadget_shapes"]["equal"] and r["mul_shapes"]["equal"]
                and r["ntt_calls"]["equal"],
                f"a kernel != plain at a sharded float shape ({layout})")
        require(r["launches_reconciled"],
                f"launches {r['launches']} != the recorded calls ({layout})")
        require(all(r["launches"][k] > 0 for k in CKKS_SHARD_KERNELS),
                f"a kernel never launched on the sharded float path "
                f"({layout}): {r['launches']}")
    require(placed["d"] == SHARDS,
            f"the placed mesh has d = {placed['d']}, not {SHARDS}")
    require(raw_equal, "placed raw scan/grid/verify values differ from "
            "the unplaced run's")
    require(answers_equal, "placed answers differ from the unplaced run's")
    return {**out, "kernel_run": flat}


class _FaeTruth:
    """What the client knows of a FAE table, and the engine's decode of
    it, in three readings of each column (one payload a global row id):

      plain — Δ·m: the unperturbed plaintext, decided exactly;
      drawn — Δ·m + round(Δ·pert) + e_m, Alg. 3's payload as the harness
              drew it (EncBasic rows, the inserts: Δ·m); a row within 6σ
              of the compare's noise of a threshold is undecided;
      phase — the phase each ciphertext decrypts to (the drawn payload
              plus its encryption noise); undecided within 6σ of the
              gadget key multiply's noise alone.

    The compare's noise: both operands' fresh noise (`core.noise.predict`)
    and the key multiply's Σ digit·e over K·D·n terms.  Its digits are
    unsigned, uniform on [0, B): E[digit²] = (B − 1)(2B − 1)/6, not the
    B²/12 of `predict`, so a key's multiply noise carries a mean of its
    own (`_key_noise` measures it) and σ here is twice `predict`'s.  A
    trapdoor reads as its payload (plain, drawn) or its own phase."""

    READINGS = ("plain", "drawn", "phase")

    def __init__(self, ks):
        import math
        from repro_torch.core import noise
        self.ks = ks
        p, b = ks.params, noise.predict(ks.params)
        Bg, B = p.gadget_base, p.noise_bound
        key_var = (p.num_towers * p.gadget_digits_per_tower * p.n
                   * (Bg - 1) * (2 * Bg - 1) / 6 * B * (B + 1) / 3)
        fresh_var = 2 * (p.scale * b.fresh_sigma) ** 2
        self.margin = {"plain": 0.0,
                       "drawn": 6 * math.sqrt(fresh_var + key_var) / p.scale,
                       "phase": 6 * math.sqrt(key_var) / p.scale}
        self.cols = {r: {} for r in self.READINGS}
        self.records, self._phases = [], {}

    def payload(self, m) -> np.ndarray:
        """`core.encrypt._payload` in numpy: Δ·m (bfv), round(Δ·m)
        (ckks, half to even)."""
        p = self.ks.params
        m = np.asarray(m)
        if p.profile.scheme == "bfv":
            return m.astype(np.int64) * p.delta_enc
        return np.round(m.astype(np.float64) * p.delta_enc).astype(np.int64)

    def add(self, col, m, pert=None, e_m=None) -> None:
        """Append rows of `col` (global id order): FAE rows with their
        drawn `pert` and `e_m`, EncBasic rows without."""
        plain = self.payload(m)
        drawn = plain if pert is None else (
            plain + np.round(np.asarray(pert)[:len(plain)]
                             * self.ks.params.delta_enc).astype(np.int64)
            + np.asarray(e_m)[:len(plain)])
        for r, x in (("plain", plain), ("drawn", drawn)):
            self.cols[r][col] = np.concatenate(
                [self.cols[r].get(col, np.zeros(0, np.int64)), x])

    def read_phases(self, table, col) -> np.ndarray:
        """Every global row's phase of `col` (base then delta)."""
        from repro_torch.core import encrypt as E
        step = E.enc_chunk_rows(self.ks.params)
        ids = np.arange(table.n_total)
        ph = np.concatenate([E.decrypt_raw(self.ks, table.gather(
            col, ids[lo:lo + step])).cpu().numpy()
            for lo in range(0, len(ids), step)])
        self.cols["phase"][col] = ph
        return ph

    def bound(self, x, ct, reading) -> int:
        if reading != "phase":
            return int(self.payload(x))
        if id(ct) not in self._phases:
            from repro_torch.core import encrypt as E
            self._phases[id(ct)] = (ct, int(E.decrypt_raw(self.ks, ct)))
        return self._phases[id(ct)][1]

    def decide(self, expr, reading) -> tuple:
        """(mask, undecided) of an expression over every row: ("eq", col,
        x, ct, eps), ("range", col, lo, ct_lo, hi, ct_hi, eps), ("and" |
        "or", a, b), ("not", a); the executor's three-way decode at the
        leaf's τ (Eq: 0; Range: ≥ 0 against lo, ≤ 0 against hi)."""
        from repro_torch.core.compare import resolve_tau
        kind = expr[0]
        if kind in ("and", "or"):
            (ma, ua), (mb, ub) = (self.decide(e, reading) for e in expr[1:])
            return (ma & mb if kind == "and" else ma | mb), ua | ub
        if kind == "not":
            m, u = self.decide(expr[1], reading)
            return ~m, u
        p = self.cols[reading][expr[1]]
        tau = resolve_tau(self.ks, expr[-1]) / self.ks.params.scale
        margin = self.margin[reading]
        d = p - self.bound(expr[2], expr[3], reading)
        if kind == "eq":
            return np.abs(d) < tau, np.abs(np.abs(d) - tau) <= margin
        d_hi = p - self.bound(expr[4], expr[5], reading)
        return ((d > -tau) & (d_hi < tau),
                (np.abs(d + tau) <= margin) | (np.abs(d_hi - tau) <= margin))

    def record(self, name, expr, mask, alive, *, decided=True) -> None:
        """Keep one answer's mask (over the global ids of its time) to be
        held against each reading by `check`; `decided`: the drawn
        reading must leave no row undecided."""
        self.records.append((name, expr, np.asarray(mask).copy(),
                             np.asarray(alive).copy(), decided))

    def check(self) -> dict:
        """Each recorded answer against the drawn and phase readings:
        equal outside their undecided rows (the drawn reading leaves none
        for `decided` answers); the undecided counts, and the rows that
        differ from the unperturbed plaintext (a part that needs none
        requires it)."""
        out = {}
        for name, expr, mask, alive, decided in self.records:
            n = len(mask)
            rec = {}
            ok = True
            for r in self.READINGS:
                want, und = self.decide(expr, r)
                want, und = want[:n] & alive, und[:n] & alive
                if r == "plain":
                    rec["differ_from_plain"] = int((mask != want).sum())
                    continue
                ok &= bool(np.array_equal(mask[~und], want[~und]))
                rec[f"{r}_undecided"] = int(und.sum())
            ok &= not (decided and rec["drawn_undecided"])
            out[name] = {"ok": ok, "matched": int(mask.sum()), **rec}
        return out


def _key_noise(ks, ct, margin, seed) -> dict:
    """The key multiply's noise on FAE_NOISE_LANES rows of a column
    against a trapdoor of 0: eval − scale·(phase − the trapdoor's
    phase), in payload units; its mean (the key's own), spread and
    largest size, which the phase reading's margin must cover."""
    from repro_torch.core import compare as C
    from repro_torch.core import encrypt as E
    rows = E.Ciphertext(ct.c0[:FAE_NOISE_LANES], ct.c1[:FAE_NOISE_LANES])
    trap = E.encrypt(ks, 0, seed)
    scale = ks.params.scale
    ev = C.eval_value(ks, rows, trap).cpu().numpy()
    dev = (ev - scale * (E.decrypt_raw(ks, rows).cpu().numpy()
                         - int(E.decrypt_raw(ks, trap)))) / scale
    return {"lanes": len(dev), "mean": float(dev.mean()),
            "std": float(dev.std()), "max_abs": float(np.abs(dev).max()),
            "margin": margin, "covered": bool(np.abs(dev).max() <= margin)}


def _fae_plan(expr):
    """The plan of a `_FaeTruth` expression."""
    from repro_torch import db
    kind = expr[0]
    if kind == "eq":
        return db.Eq(expr[1], expr[3], eps=expr[4])
    if kind == "range":
        return db.Range(expr[1], expr[3], expr[5], eps=expr[6])
    if kind == "not":
        return db.Not(_fae_plan(expr[1]))
    return (db.And if kind == "and" else db.Or)(*map(_fae_plan, expr[1:]))


def _fae_order(truth, col, ids, vals, sel, descending) -> dict:
    """An order stage's answer on a FAE column: its plaintext values must
    equal the selection's in order; the share of row ids that differ
    from the plaintext's stable order (a tie class is ordered by its
    perturbations); and the adjacent pairs whose drawn payloads are out
    of order by more than the compare's noise (must be none)."""
    sign = -1 if descending else 1
    plain = sel[np.argsort(sign * vals[sel], kind="stable")][:len(ids)]
    p = truth.cols["drawn"][col][ids]
    return {"rows": int(len(ids)),
            "values_ok": bool(np.array_equal(vals[ids], vals[plain])),
            "ids_differ_share": float(np.mean(ids != plain))
            if len(ids) else 0.0,
            "inversions": int((sign * np.diff(p)
                               < -truth.margin["drawn"]).sum())}


def _fae_f2(ks, value, seed) -> dict:
    """Finding F2 over FAE_PAIRS pairs of FAE encryptions of one value:
    Alg. 4's flip share, the τ-decode's tie rate (compare == 0), and the
    EncBasic control's tie rate."""
    import torch
    from repro_torch.core import compare as C
    from repro_torch.core import encrypt as E
    m = torch.full((FAE_PAIRS,), value, device=ks.device)
    f1, f2 = (E.encrypt_fae(ks, m, seed + i) for i in (0, 1))
    b1, b2 = (E.encrypt(ks, m, seed + i) for i in (2, 3))
    return {"pairs": FAE_PAIRS, "value": float(value),
            "flip_share": float(C.compare_fae(ks, f1, f2).double().mean()),
            "tau_probe_rate": float((C.compare(ks, f1, f2) == 0)
                                    .double().mean()),
            "basic_zero_rate": float((C.compare(ks, b1, b2) == 0)
                                     .double().mean())}


def _fae_require(out, part) -> None:
    require(out["exact"], f"a FAE answer ({part}) diverged: {out['checks']}")
    require(out["shapes_equal"], f"a kernel != plain at a FAE shape ({part})")
    require(out["launches_reconciled"],
            f"launches {out['launches']} != the recorded calls ({part})")
    require(all(out["launches"][k] > 0 for k in FAE_KERNELS),
            f"a kernel never launched on the FAE path ({part}): "
            f"{out['launches']}")


def _fae_draws(ks, rng, n_pad) -> tuple:
    """Alg. 3's operands for n_pad rows, as `encrypt_fae` draws them:
    pert ~ U(-ε, ε), e_m uniform on [-B, B]."""
    p = ks.params
    return (rng.uniform(-p.epsilon, p.epsilon, n_pad),
            rng.integers(-p.noise_bound, p.noise_bound + 1, n_pad))


def phase_fae(ks, vals, rate) -> dict:
    """Part (a): a FAE table over full hg38 at PROFILE in gadget mode, on
    the serve phase's keys.  Two FAE columns, v (the positions) and the
    tie-heavy w = v // FAE_BIN, whose Alg. 3 operands the harness draws
    (`Table.from_arrays(samples=)`); SortedIndex on each; Ranges on v
    (linear and indexed), Eq on w at the native τ (linear and indexed),
    And/Or; TopK FAE_TOPK and OrderBy on w; a QueryServer batch of 8
    over both indexes; WRITE_SHARE × rows inserts (EncBasic, as the
    reference's) and a delete, reads over base ∪ delta, compaction into
    both indexes, the reads again; v's index retired, the sort-merge Eq
    join of w against an EncBasic table of its distinct values; Finding
    F2 over FAE_PAIRS pairs.  Every Range/Eq answer equals the
    plaintext's (F2: the perturbation is ~1 % of τ here) and the drawn
    and decrypted perturbed readings (`_FaeTruth`); order stages' values
    equal the plaintext's in order; join pairs equal the plaintext's.
    Then every kernel shape against plain, launches reconciled."""
    import torch

    from repro_torch import db
    from repro_torch.core import encrypt as E
    from repro_torch.core.compare import next_pow2
    from repro_torch.kernels import _build

    hp = ks.params
    rng = np.random.default_rng(SEED + 80)
    n = len(vals)
    data = {"v": vals, "w": vals // FAE_BIN}
    draws = {c: _fae_draws(ks, rng, next_pow2(n)) for c in data}
    truth = _FaeTruth(ks)
    for c, m in data.items():
        truth.add(c, m, *draws[c])
    seeds = iter(range(9000, 10000))
    walls, peaks, ok = {}, {}, {}

    def sync_s(t0):
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def peak(name):
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()

    def eq(col, x):
        return ("eq", col, int(x), E.encrypt(ks, int(x), next(seeds)), None)

    def rng_expr(col, lo, hi):
        return ("range", col, int(lo), E.encrypt(ks, int(lo), next(seeds)),
                int(hi), E.encrypt(ks, int(hi), next(seeds)), None)

    def draw_range(width):
        lo = int(rng.integers(0, hp.t - width))
        return lo, lo + width

    def run(name, expr, table, indexes=None, t_key=None):
        t0 = time.perf_counter()
        res = db.execute(ks, table, _fae_plan(expr), indexes=indexes)
        if t_key:
            walls[t_key] = walls.get(t_key, 0.0) + sync_s(t0)
        truth.record(name, expr, res.mask, table.alive)
        return res

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    gshapes, gstop = record_gadget_shapes()
    mshapes, mstop = record_mul_shapes()
    ncalls, nstop = record_calls(("ntt_br",))
    try:
        t0 = time.perf_counter()
        t = db.Table.from_arrays(
            ks, "hg38_fae", data, SEED + 81, fae=True,
            samples={c: (None, None, None, *draws[c]) for c in data})
        walls["encrypt_s"] = sync_s(t0)
        idx = {}
        for c in ("v", "w"):
            t0 = time.perf_counter()
            idx[c] = db.SortedIndex.build(ks, t, c)
            walls[f"index_{c}_s"] = sync_s(t0)
            ok[f"index_{c}"] = bool(np.all(np.diff(data[c][idx[c].perm])
                                           >= 0))
        peak("build")

        # ---- reads: Ranges on v, Eq on w, And/Or, linear and indexed ---
        w = data["w"]
        cls, counts = np.unique(w, return_counts=True)
        heavy = [int(cls[np.argmax(counts)]), int(rng.choice(w))]
        exprs = {f"range{i}": rng_expr("v", *draw_range(wd))
                 for i, wd in enumerate((50, 500, 5000, 20000))}
        exprs |= {f"eq{i}": eq("w", x) for i, x in enumerate(heavy)}
        exprs["and"] = ("and", exprs["range2"], eq("w", w[n // 3]))
        exprs["or"] = ("or", exprs["eq1"], exprs["range0"])
        for name, expr in exprs.items():
            for how, use in (("linear", None), ("indexed", idx)):
                run(f"{name}_{how}", expr, t, use,
                    f"{name.rstrip('0123456789')}_{how}_s")
        peak("reads")

        # ---- TopK and OrderBy on the tie-heavy FAE column --------------
        lo, hi = (int(x) for x in np.percentile(vals, [30, 70]))
        sel = np.nonzero((vals >= lo) & (vals <= hi))[0]
        where = rng_expr("v", lo, hi)
        t0 = time.perf_counter()
        res = db.execute(ks, t, db.Query(where=_fae_plan(where),
                                         top_k=db.TopK("w", FAE_TOPK)))
        walls["topk_s"] = sync_s(t0)
        topk = _fae_order(truth, "w", res.row_ids, w, sel, True)
        ordered = np.sort(vals)
        lo2, hi2 = (int(ordered[i]) for i in (n // 2, n // 2 + FAE_ORDER_ROWS))
        sel2 = np.nonzero((vals >= lo2) & (vals <= hi2))[0]
        t0 = time.perf_counter()
        res = db.execute(ks, t, db.Query(
            where=_fae_plan(rng_expr("v", lo2, hi2)),
            order_by=db.OrderBy("w")))
        walls["order_by_s"] = sync_s(t0)
        order_by = _fae_order(truth, "w", res.row_ids, w, sel2, False)
        ok["topk"] = topk["values_ok"] and not topk["inversions"]
        ok["order_by"] = (order_by["values_ok"] and not order_by["inversions"]
                          and order_by["rows"] == len(sel2))
        peak("order")

        # ---- a QueryServer batch of 8 over both indexes ----------------
        batch = [exprs[k] for k in ("range0", "range1", "range2", "range3",
                                    "eq0", "eq1")]
        batch += [("and", rng_expr("v", *draw_range(3000)),
                   eq("w", w[n // 5])),
                  ("or", eq("w", w[n // 7]), rng_expr("v", 0, 100))]
        server = db.QueryServer(ks, t, indexes=idx, batch=len(batch))
        qids = [server.submit(_fae_plan(e)) for e in batch]
        t0 = time.perf_counter()
        got = server.run()
        walls["batch_s"] = sync_s(t0)
        for i, (qid, e) in enumerate(zip(qids, batch)):
            truth.record(f"batch{i}", e, got[qid].mask, t.alive)
        bs = server.batch_log[0]
        served = {"queries": bs.queries, "eval_calls": bs.eval_calls,
                  "index_compares": bs.index_compares}
        del server, got
        peak("batch")

        # ---- writes on the FAE base: EncBasic inserts, a delete --------
        m_ins = max(8, round(WRITE_SHARE * n))
        ins_v = rng.choice(vals, m_ins)
        ins = {"v": ins_v, "w": ins_v // FAE_BIN}
        t0 = time.perf_counter()
        new_ids = t.insert(ks, ins, SEED + 82)
        walls["insert_s"] = sync_s(t0)
        for c in data:
            truth.add(c, ins[c])
        all_w = np.concatenate([w, ins["w"]])
        ok["insert_delete"] = bool(
            np.array_equal(new_ids, np.arange(n, n + m_ins))
            and t.delete([n // 2]) == 1)
        union = {"range": rng_expr("v", *draw_range(2000)),
                 "eq": eq("w", ins["w"][m_ins // 2])}

        def union_reads(tag):
            for name, expr in union.items():
                for how, use in (("linear", None), ("indexed", idx)):
                    run(f"{tag}_{name}_{how}", expr, t, use,
                        f"{tag}_{how}_s")
        union_reads("union")
        peak("union_reads")
        t0 = time.perf_counter()
        cstats = db.compact(ks, t, idx)
        walls["compact_s"] = sync_s(t0)
        all_v = np.concatenate([vals, ins_v])
        ok["compact"] = bool(
            not t.has_delta
            and all(np.all(np.diff(x[idx[c].perm]) >= 0)
                    for c, x in (("v", all_v), ("w", all_w)))
            and 0 < cstats.merge_compares < cstats.rebuild_compares)
        peak("compact")
        union_reads("post_compact")

        # ---- the sort-merge Eq join: w against its distinct values -----
        del idx["v"]
        gc.collect()
        torch.cuda.empty_cache()
        keys = np.unique(all_w)
        right = db.Table.from_arrays(ks, "hg38_bins", {"w": keys},
                                     SEED + 83)
        t0 = time.perf_counter()
        jres = db.execute_join(ks, t, right, db.Join(None, None, on="w"),
                               strategy="sort_merge",
                               left_indexes={"w": idx["w"]})
        walls["join_s"] = sync_s(t0)
        live = np.nonzero(t.alive)[0]
        want_pairs = np.stack([live, np.searchsorted(keys, all_w[live])], 1)
        ok["join"] = bool(np.array_equal(jres.pairs, want_pairs))
        js = jres.stats
        join = {"pairs": len(jres), "build_compares": js.build_compares,
                "merge_compares": js.merge_compares,
                "adjacency_compares": js.adjacency_compares}
        del jres
        peak("join")

        # ---- Finding F2, the key multiply's noise ----------------------
        t0 = time.perf_counter()
        f2 = _fae_f2(ks, int(vals[0]), SEED + 84)
        walls["f2_s"] = sync_s(t0)
        ok["f2"] = (FAE_FLIP_BAND[0] <= f2["flip_share"] <= FAE_FLIP_BAND[1]
                    and f2["basic_zero_rate"] == 1.0)
        key_noise = _key_noise(ks, t.columns["v"], truth.margin["phase"],
                               SEED + 86)
        ok["key_noise"] = key_noise["covered"]
        col = t.columns["w"]
        source = E.Ciphertext(col.c0[:256].clone(), col.c1[:256].clone())
        del col
    finally:
        gstop()
        mstop()
        nstop()
    launches = dict(_build.LAUNCHES)
    for c in data:
        truth.read_phases(t, c)
    payload_err = max(int(np.abs(truth.cols["phase"][c]
                                 - truth.cols["drawn"][c]).max())
                      for c in data)
    del t, idx, right
    gc.collect()
    torch.cuda.empty_cache()
    checks = truth.check()
    for name, r in checks.items():
        ok[name] = r["ok"] and not r["differ_from_plain"]
    kern = _gadget_path_checks(ks, source, gshapes, mshapes, ncalls, launches,
                              SEED + 85, rate)
    del source, ncalls
    out = {
        "phase": "fae", "part": "a", "profile": hp.profile.name,
        "mode": "gadget", "n": hp.n, "rows": n, "n_padded": next_pow2(n),
        "bin": FAE_BIN, "tie_classes": len(cls),
        "largest_tie_class": int(counts.max()),
        "inserted": m_ins, "deleted": 1,
        "epsilon": hp.epsilon, "tau": hp.tau,
        "margins": truth.margin, "payload_max_noise": payload_err,
        "exact": all(ok.values()), "checks": ok, "answers": checks,
        "topk": topk, "order_by": order_by, "batch": served, "join": join,
        "compact": {"merge_compares": cstats.merge_compares,
                    "rebuild_compares": cstats.rebuild_compares,
                    "rounds": cstats.merge_rounds},
        "f2": f2, "key_noise": key_noise, "walls": walls,
        "queries_per_s": len(batch) / walls["batch_s"],
        "inserts_per_s": m_ins / walls["insert_s"],
        "peak_mem_bytes": max(peaks.values()), "peaks": peaks,
        "launches": launches,
        **{k: kern[k] for k in ("shapes_equal", "launches_reconciled",
                                "gadget_shapes", "mul_shapes", "ntt_calls")},
    }
    emit(out)
    _fae_require(out, "a")
    return out


def phase_fae_ckks(ks, rate) -> dict:
    """Part (b): FAE tables at CKKS_PROFILE in gadget mode on the float
    phase's keys: (a) bitcoin's 1,085 rows and (b) hg38's first
    CKKS_ROWS rows, each with v and a lattice aux, every column FAE with
    operands the harness draws.  SortedIndex on each v; the float
    phase's traffic (an ε-band Eq, CKKS_RANGES Ranges with off-lattice
    bounds, linear and indexed, And(Range, ε-band Eq) + TopK 5, on both;
    a QueryServer batch of 8 over (b)'s index, each lane its own ε; the
    ε-band sort-merge join (b).v × (a).v), whose bands and bounds lie
    ≥ 0.125 from every lattice step, so the perturbation (≤ 0.02 between
    two rows) decides none of them: each answer equals the drawn
    reading with no row undecided.  Then the trap (τ = 2^-7 against ε =
    0.01): Eq at the native τ and at ε = one lattice step, linear and
    indexed, held against the drawn and decrypted readings outside their
    noise bands, and the rows where they differ from the unperturbed
    plaintext counted.  Every kernel shape against plain, launches
    reconciled."""
    import torch

    from repro_torch import db
    from repro_torch.core import encrypt as E
    from repro_torch.core.compare import next_pow2, resolve_tau
    from repro_torch.kernels import _build

    G = CKKS_GRID
    hp = ks.params
    rng = np.random.default_rng(SEED + 90)
    vals = {"a": _float_dataset("bitcoin"),
            "b": _float_dataset("hg38", CKKS_ROWS)}
    aux = {k: _lattice(rng, len(v)) for k, v in vals.items()}
    seeds = iter(range(11000, 12000))
    walls, peaks, ok = {}, {}, {}
    truths = {k: _FaeTruth(ks) for k in vals}
    draws = {}
    for k, v in vals.items():
        for c, m in (("v", v), ("aux", aux[k])):
            draws[k, c] = _fae_draws(ks, rng, next_pow2(len(v)))
            truths[k].add(c, m, *draws[k, c])

    def sync_s(t0):
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def peak(name):
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()

    def fenc(x):
        return E.encrypt(ks, float(x), next(seeds))

    def eq(col, x, eps):
        return ("eq", col, float(x), fenc(x), eps)

    def rng_expr(col, lo, hi, eps=None):
        return ("range", col, lo, fenc(lo), hi, fenc(hi), eps)

    def draw_range(v):
        lo, hi = np.sort(rng.choice(v, 2, replace=False))
        return float(lo) - G / 2, float(hi) + G / 2

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    gshapes, gstop = record_gadget_shapes()
    mshapes, mstop = record_mul_shapes()
    ncalls, nstop = record_calls(("ntt_br",))
    try:
        tables, idx = {}, {}
        for k in ("a", "b"):
            t0 = time.perf_counter()
            tables[k] = db.Table.from_arrays(
                ks, f"fae_{k}", {"v": vals[k], "aux": aux[k]},
                SEED + 91 + (k == "b"), fae=True,
                samples={c: (None, None, None, *draws[k, c])
                         for c in ("v", "aux")})
            walls[f"encrypt_{k}_s"] = sync_s(t0)
        for k in ("a", "b"):
            t0 = time.perf_counter()
            idx[k] = db.SortedIndex.build(ks, tables[k], "v")
            walls[f"index_{k}_s"] = sync_s(t0)
            ok[f"index_{k}"] = bool(np.all(np.diff(
                vals[k][idx[k].perm]) >= 0))
        peak("build")

        # ---- the float phase's traffic, then the trap -------------------
        for k in ("a", "b"):
            v, t, ix, tr = vals[k], tables[k], {"v": idx[k]}, truths[k]
            n = len(v)
            exprs = {"eq_band": eq("v", v[n // 3], 2 * G + G / 2)}
            exprs |= {f"range{i}": rng_expr("v", *draw_range(v))
                      for i in range(CKKS_RANGES)}
            lo = float(np.percentile(v, 30)) - G / 2
            hi = float(np.percentile(v, 70)) + G / 2
            and_expr = ("and", rng_expr("v", lo, hi),
                        eq("aux", aux[k][n // 2], G + G / 2))
            trap = {"eq_native": eq("v", v[n // 2], None),
                    "eq_one_step": eq("v", v[n // 4], G)}
            for group, decided in ((exprs, True), (trap, False)):
                for name, expr in group.items():
                    for how, use in (("linear", None), ("indexed", ix)):
                        t0 = time.perf_counter()
                        res = db.execute(ks, t, _fae_plan(expr), indexes=use)
                        key = f"{name.rstrip('0123456789')}_{how}_{k}_s"
                        walls[key] = walls.get(key, 0.0) + sync_s(t0)
                        tr.record(f"{name}_{how}", expr, res.mask,
                                  t.alive, decided=decided)
            t0 = time.perf_counter()
            res = db.execute(ks, t, db.Query(where=_fae_plan(and_expr),
                                             top_k=db.TopK("v", 5)))
            walls[f"and_topk_{k}_s"] = sync_s(t0)
            tr.record("and_topk", and_expr, res.mask, t.alive)
            sel = np.nonzero(res.mask)[0]
            ok[f"topk_{k}"] = _fae_order(tr, "v", res.row_ids, v, sel,
                                         True)["values_ok"]
        del ix, use
        peak("queries")

        # ---- a batch of 8 over (b)'s index, each with its own τ --------
        v = vals["b"]
        batch = [eq("v", rng.choice(v), e)
                 for e in (G + G / 2, 2 * G + G / 2, 3 * G + G / 2,
                           4 * G + G / 2)]
        batch += [rng_expr("v", *draw_range(v), e)
                  for e in (None, G, 2 * G, 3 * G)]
        server = db.QueryServer(ks, tables["b"], indexes={"v": idx["b"]},
                                batch=len(batch))
        qids = [server.submit(_fae_plan(e)) for e in batch]
        t0 = time.perf_counter()
        got = server.run()
        walls["batch_s"] = sync_s(t0)
        for i, (qid, e) in enumerate(zip(qids, batch)):
            truths["b"].record(f"batch{i}", e, got[qid].mask,
                               tables["b"].alive)
        del server, got
        peak("batch")

        # ---- the ε-band sort-merge join of (b).v against (a).v ----------
        band = G + G / 2
        t0 = time.perf_counter()
        jres = db.execute_join(
            ks, tables["b"], tables["a"],
            db.Join(None, None, on="v", eps=band), strategy="sort_merge",
            left_indexes={"v": idx["b"]}, right_indexes={"v": idx["a"]})
        walls["join_s"] = sync_s(t0)
        pairs = jres.pairs
        js = jres.stats
        join = {"pairs": len(jres), "merge_compares": js.merge_compares,
                "adjacency_compares": js.adjacency_compares,
                "verify_compares": js.verify_compares}
        del jres
        peak("join")
        key_noise = _key_noise(ks, tables["b"].columns["v"],
                               truths["b"].margin["phase"], SEED + 96)
        ok["key_noise"] = key_noise["covered"]
        col = tables["a"].columns["v"]
        source = E.Ciphertext(col.c0[:256].clone(), col.c1[:256].clone())
        del col
    finally:
        gstop()
        mstop()
        nstop()
    launches = dict(_build.LAUNCHES)
    for k in ("a", "b"):
        for c in ("v", "aux"):
            truths[k].read_phases(tables[k], c)
    payload_err = max(int(np.abs(tr.cols["phase"][c]
                                 - tr.cols["drawn"][c]).max())
                      for tr in truths.values() for c in ("v", "aux"))
    del tables, idx
    gc.collect()
    torch.cuda.empty_cache()
    checks = {k: tr.check() for k, tr in truths.items()}
    for k, per in checks.items():
        for name, r in per.items():
            ok[f"{k}_{name}"] = r["ok"]
    # the join: pairs by the drawn payloads, none within the noise band
    tau = resolve_tau(ks, band) / hp.scale
    d = (truths["b"].cols["drawn"]["v"][:len(vals["b"]), None]
         - truths["a"].cols["drawn"]["v"][None, :len(vals["a"])])
    want_pairs = np.argwhere(np.abs(d) < tau)
    join["undecided"] = int((np.abs(np.abs(d) - tau)
                             <= truths["b"].margin["drawn"]).sum())
    plain_pairs = np.argwhere(np.abs(vals["b"][:, None]
                                     - vals["a"][None, :]) <= band)
    del d
    ok["join"] = bool(np.array_equal(pairs, want_pairs)
                      and not join["undecided"]
                      and join["verify_compares"] > 0)
    join["differ_from_plain"] = int(len(pairs) != len(plain_pairs)
                                    or not np.array_equal(pairs,
                                                          plain_pairs))
    kern = _gadget_path_checks(ks, source, gshapes, mshapes, ncalls, launches,
                              SEED + 95, rate)
    del source, ncalls
    out = {
        "phase": "fae", "part": "b", "profile": hp.profile.name,
        "mode": "gadget", "n": hp.n, "grid": G, "epsilon": hp.epsilon,
        "tau_units": hp.tau / (hp.scale * hp.delta_enc),
        "rows": {k: len(v) for k, v in vals.items()},
        "margins": truths["b"].margin, "payload_max_noise": payload_err,
        "exact": all(ok.values()), "checks": ok, "answers": checks,
        "differ_from_plain": {k: sum(r["differ_from_plain"]
                                     for r in per.values())
                              for k, per in checks.items()},
        "join": join, "key_noise": key_noise, "walls": walls,
        "queries_per_s": len(batch) / walls["batch_s"],
        "peak_mem_bytes": max(peaks.values()), "peaks": peaks,
        "launches": launches,
        **{k: kern[k] for k in ("shapes_equal", "launches_reconciled",
                                "gadget_shapes", "mul_shapes", "ntt_calls")},
    }
    emit(out)
    _fae_require(out, "b")
    return out


def _serve_and_trace(cfg, params, prompts, dev, frames=None) -> dict:
    """The LM serve path on the card: a warm-up batch, then LM_REQUESTS
    requests in batches of LM_BATCH (the prompts' length each), LM_GEN
    greedy tokens (`launch/serve.serve_requests`; `frames` per request
    for an encoder-decoder, zero patches for a patches model); then one
    batch's decode steps again under
    torch.profiler (device busy time, kernels a step, the host's top
    operations)."""
    import torch
    from repro_torch.launch.serve import serve_requests
    from repro_torch.models import serve as SV
    from torch.profiler import ProfilerActivity, profile

    serve_requests(cfg, params, prompts[:LM_BATCH], batch=LM_BATCH, gen=2,
                   frames=None if frames is None else frames[:LM_BATCH])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = serve_requests(cfg, params, prompts, batch=LM_BATCH, gen=LM_GEN,
                         frames=frames)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    finite = bool(torch.isfinite(out["logits"].float()).all())
    steps = (LM_REQUESTS // LM_BATCH) * (LM_GEN - 1)
    step_ms = out["decode_s"] / steps * 1e3

    inputs = {"tokens": torch.as_tensor(prompts[:LM_BATCH],
                                        dtype=torch.int32, device=dev)}
    if frames is not None:
        inputs["frames"] = frames[:LM_BATCH]
    if cfg.frontend == "patches":         # as serve_requests feeds them
        inputs["patches"] = torch.zeros(
            (LM_BATCH, cfg.num_patches, cfg.d_model),
            dtype=getattr(torch, cfg.dtype), device=dev)
    logits, cache = SV.prefill(cfg, params, inputs,
                               T_max=prompts.shape[1] + LM_GEN)
    tok = torch.argmax(logits, -1).to(torch.int32)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(LM_GEN - 1):
            logits, cache = SV.decode_step(cfg, params, cache, tok)
            tok = torch.argmax(logits, -1).to(torch.int32)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    dec_dev = _device_summary(prof, prof_wall, top=8)
    host_ops = sorted(prof.key_averages(),
                      key=lambda e: -e.self_cpu_time_total)
    busy_ms = (None if dec_dev["busy_s"] is None
               else dec_dev["busy_s"] / (LM_GEN - 1) * 1e3)
    decode_trace = {
        "steps": LM_GEN - 1, "wall_s": prof_wall,
        "device_busy_ms_per_step": busy_ms,
        "kernels_per_step": dec_dev["events"] / (LM_GEN - 1),
        "unprofiled_step_ms": step_ms,
        "busy_share_of_unprofiled_step": None if busy_ms is None
        else busy_ms / step_ms, **dec_dev,
        "host_ms_by_op": {e.key[:60]: {"count": e.count,
                                       "self_ms": e.self_cpu_time_total / 1e3}
                          for e in host_ops[:8]}}
    return {"out": out, "wall_s": wall, "peak_mem_bytes": peak,
            "finite": finite, "decode_step_ms": step_ms,
            "tokens_per_s": LM_REQUESTS * LM_GEN / wall,
            "decode_tokens_per_s": LM_REQUESTS * (LM_GEN - 1)
            / out["decode_s"], "decode_trace": decode_trace}


def _f32_card_vs_cpu(f32, p32, inputs) -> dict:
    """float32 prefill on the card against the same prefill on the CPU
    (`inputs` on the host), as max |card − CPU| / max |CPU|; the control
    is the card's prefill with TF32 matmuls, which must exceed the limit
    LM_CPU_REL_TOL."""
    import torch
    from repro_torch.models import serve as SV
    from repro_torch.models import transformer as T

    dev = next(_leaves(p32)).device
    on_dev = {k: v.to(dev) for k, v in inputs.items()}
    got, _ = SV.prefill(f32, p32, on_dev)
    tf32_was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32, _ = SV.prefill(f32, p32, on_dev)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32_was
    cpu32 = T.map_params(lambda a: a.cpu(), p32)
    want, _ = SV.prefill(f32, cpu32, inputs)
    del cpu32
    cpu_err = float((got.cpu() - want).abs().max())
    scale = float(want.abs().max())
    return {"max_abs_err": cpu_err, "rel_err": cpu_err / scale,
            "tolerance_rel": LM_CPU_REL_TOL,
            "tf32_control_rel_err": float((tf32.cpu() - want).abs().max())
            / scale}


def _decode_vs_forward(f32, p32, inputs) -> list:
    """LM_DECODE_CHECK greedy float32 decode steps after a prefill of
    `inputs` (on the card), each step's logits against `forward` over
    the grown sequence: max |decode − forward| per step."""
    import torch
    from repro_torch.models import serve as SV
    from repro_torch.models import transformer as T

    toks = inputs["tokens"]
    logits, cache = SV.prefill(f32, p32, inputs,
                               T_max=toks.shape[1] + LM_DECODE_CHECK)
    grown, errs = toks, []
    for _ in range(LM_DECODE_CHECK):
        nxt = torch.argmax(logits, -1).to(torch.int32)
        grown = torch.cat([grown, nxt[:, None]], 1)
        logits, cache = SV.decode_step(f32, p32, cache, nxt)
        full = T.forward(f32, p32, {**inputs, "tokens": grown})[:, -1]
        errs.append(float((full - logits).abs().max()))
    return errs


def _require_lm(served, f32check, dec_errs) -> None:
    require(served["finite"], "non-finite logits")
    require(f32check["rel_err"] <= f32check["tolerance_rel"],
            f"float32 card vs CPU: {f32check}")
    require(f32check["tf32_control_rel_err"] > f32check["tolerance_rel"],
            f"the TF32 control passes the float32 limit: {f32check}")
    require(served["decode_trace"]["events"] > 0,
            "the decode trace saw no kernel")
    require(max(dec_errs) <= LM_DECODE_TOL,
            f"decode_step vs forward: {dec_errs}")


def phase_lm(dev, rate) -> dict:
    """The LM serve path at LM_ARCH's full width (bfloat16, seeded random
    weights): 8 requests in batches of 4, prompt 32, 16 greedy tokens
    (`launch/serve.serve_requests`).  Checks on the card: float32 prefill
    against the port's CPU float32 run, decode_step against forward over
    the grown sequence, the share of bfloat16 greedy tokens equal to the
    float32 ones.  Then `examples/secure_topk_serving.py` at full size:
    one request's last-token logits over LM_CANDIDATES token ids,
    encrypted under LM_PROFILE gadget keys, `encrypted_topk` k = 8, each
    pick within the CKKS tolerance of the plaintext k-th score; the
    gadget Eval and both multiplies held against their plain versions at
    every shape the bridge launched them at."""
    import dataclasses

    import torch
    from repro_torch import configs
    from repro_torch.core import compare as C
    from repro_torch.core import encrypt as E
    from repro_torch.core.ckks import equality_tolerance
    from repro_torch.core.keys import keygen
    from repro_torch.core.params import make_params
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import serve_requests
    from repro_torch.models import serve as SV
    from repro_torch.models import transformer as T

    cfg = (configs.get_reduced if LM_REDUCED else configs.get_config)(
        LM_ARCH)
    f32 = dataclasses.replace(cfg, param_dtype="float32", dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(SEED + 40)
    t0 = time.perf_counter()
    params = T.init_params(cfg, gen, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(int(np.prod(a.shape)) for a in _leaves(params))
    rng = np.random.default_rng(SEED + 41)
    prompts = rng.integers(0, cfg.vocab_size, (LM_REQUESTS, LM_PROMPT))

    served = _serve_and_trace(cfg, params, prompts, dev)
    out16, decode_trace = served["out"], served["decode_trace"]

    # ---- float32: the card against the CPU, decode against forward -------
    p32 = T.map_params(lambda a: a.float(), params)
    toks = torch.as_tensor(prompts[:LM_BATCH], dtype=torch.int32)
    f32check = _f32_card_vs_cpu(f32, p32, {"tokens": toks})
    dec_errs = _decode_vs_forward(f32, p32, {"tokens": toks.to(dev)})
    out32 = serve_requests(f32, p32, prompts, batch=LM_BATCH, gen=LM_GEN)
    greedy_share = float(np.mean(out32["tokens"] == out16["tokens"]))
    del p32, out32
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the bridge: encrypted top-k over one request's scores -----------
    scores_all = SV.prefill(cfg, params, {"tokens": toks[:1].to(dev)})[0]
    cand = rng.choice(cfg.vocab_size, LM_CANDIDATES, replace=False)
    scores = scores_all[0].double().cpu().numpy()[cand]
    del params
    gc.collect()
    torch.cuda.empty_cache()
    hp = make_params(LM_PROFILE, mode="gadget")
    tol = equality_tolerance(hp)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    gshapes, gstop = record_gadget_shapes()
    mshapes, mstop = record_mul_shapes()
    walls = {}
    try:
        t0 = time.perf_counter()
        ks = keygen(hp, SEED + 42, device=dev)
        torch.cuda.synchronize()
        walls["keygen_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        enc = E.encrypt(ks, torch.as_tensor(scores, device=dev), SEED + 43)
        torch.cuda.synchronize()
        walls["encrypt_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        _, top = C.encrypted_topk(ks, enc, LM_TOPK)
        top = top.cpu().numpy()
        walls["topk_s"] = time.perf_counter() - t0
    finally:
        gstop()
        mstop()
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    kth = float(np.sort(scores)[-LM_TOPK])
    topk_ok = bool(len(set(top.tolist())) == LM_TOPK
                   and np.all(scores[top] >= kth - tol))
    exact = set(np.argsort(scores)[-LM_TOPK:].tolist())
    gadget = check_gadget_shapes(ks, enc, gshapes, SEED + 44, rate)
    muls = check_mul_shapes(ks, mshapes, SEED + 45, rate)
    g_calls = sum(s["calls"] * s["launches_per_call"]
                  for s in gadget["shapes"])
    m_calls = {k: sum(s["calls"] for s in muls["shapes"] if s["kind"] == k)
               for k in ("key", "var")}
    reconciled = (g_calls == launches["eval_coeff0_gadget"]
                  and m_calls["key"] == launches["negacyclic_mul_ntt"]
                  and m_calls["var"] == launches["negacyclic_mul"])
    del enc, ks
    gc.collect()
    torch.cuda.empty_cache()
    out = {
        "phase": "lm", "arch": cfg.name, "dtype": cfg.dtype,
        "layers": cfg.num_layers, "d_model": cfg.d_model,
        "params": n_params, "init_s": init_s,
        "requests": LM_REQUESTS, "batch": LM_BATCH, "prompt": LM_PROMPT,
        "gen": LM_GEN, "prefill_s": out16["prefill_s"],
        "decode_s": out16["decode_s"], "wall_s": served["wall_s"],
        "tokens_per_s": served["tokens_per_s"],
        "decode_tokens_per_s": served["decode_tokens_per_s"],
        "lm_peak_mem_bytes": served["peak_mem_bytes"],
        "finite": served["finite"], "f32_card_vs_cpu": f32check,
        "decode_step_ms": served["decode_step_ms"],
        "decode_trace": decode_trace,
        "f32_decode_vs_forward": {"max_abs_err": dec_errs,
                                  "tolerance_abs": LM_DECODE_TOL},
        "bf16_greedy_equal_share": greedy_share,
        "bridge": {"profile": LM_PROFILE, "candidates": LM_CANDIDATES,
                   "k": LM_TOPK, "ciphertext_bytes": 2 * 8 * LM_CANDIDATES
                   * hp.num_towers * hp.n, "tolerance": tol,
                   "topk_ok": topk_ok, "kth_score": kth,
                   "picked_scores": scores[top].tolist(),
                   "exact_overlap": len(exact & set(top.tolist())),
                   "walls": walls, "peak_mem_bytes": peak},
        "launches": launches, "launches_reconciled": reconciled,
        "gadget_shapes": gadget, "mul_shapes": muls,
    }
    emit(out)
    _require_lm(served, f32check, dec_errs)
    require(topk_ok, f"encrypted top-{LM_TOPK} below the plaintext bound")
    require(gadget["equal"] and muls["equal"],
            "a kernel != plain at a paper-ckks shape")
    require(reconciled, f"launches {launches} != the recorded calls")
    require(all(launches[k] > 0 for k in LM_KERNELS),
            f"a kernel never launched on the bridge: {launches}")
    return out


def _reduced_depth(cfg, params):
    """`cfg` and `params` cut to the first layer group (and a whisper
    model's first encoder layer) at full width, in float32."""
    import dataclasses

    from repro_torch.models import transformer as T

    cut = {"encoder_layers": 1} if cfg.is_encoder_decoder else {}
    f32 = dataclasses.replace(cfg, num_layers=cfg.group_size,
                              param_dtype="float32", dtype="float32", **cut)
    first = lambda tree: T.map_params(lambda a: a[:1].float(), tree)
    p32 = {k: T.map_params(lambda a: a.float(), v)
           for k, v in params.items() if k not in ("groups", "encoder")}
    p32["groups"] = first(params["groups"])
    if "encoder" in params:
        p32["encoder"] = {
            "groups": first(params["encoder"]["groups"]),
            "final_norm": T.map_params(lambda a: a.float(),
                                       params["encoder"]["final_norm"])}
    return f32, p32


def _fit_depth(cfg, layers=None):
    """`cfg` cut to `layers` (a cut of an earlier path's depth), or to
    the most layer groups whose weights leave LM_FAMILY_HEADROOM of the
    card's free memory, whichever is fewer; and the cut, or None."""
    import dataclasses

    import torch

    free = torch.cuda.mem_get_info()[0]
    emb = cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    per_layer = (cfg.param_count() - emb) / cfg.num_layers
    itemsize = torch.finfo(getattr(torch, cfg.param_dtype)).bits // 8
    fit = int(((free - LM_FAMILY_HEADROOM) / itemsize - emb) // per_layer)
    n = min(cfg.num_layers, layers or cfg.num_layers,
            fit - fit % cfg.group_size)
    if n == cfg.num_layers:
        return cfg, None
    why = ("the script's time" if layers and n == layers
           else "the card's memory")
    return dataclasses.replace(cfg, num_layers=n), {
        "layers": n, "published_layers": cfg.num_layers, "for": why,
        "free_bytes": free}


def record_routes() -> tuple:
    """Record the expert ids [T, k] of every `moe.route` call until
    `stop()`, in call order (the MoE blocks reach it through the
    module's global)."""
    from repro_torch.models import moe as MOE
    inner, ids = MOE.route, []

    def recorded(*args, **kwargs):
        res = inner(*args, **kwargs)
        ids.append(res[0])
        return res

    def stop():
        MOE.route = inner
    MOE.route = recorded
    return ids, stop


def phase_lm_family(dev, arch: str, seed: int) -> dict:
    """One LM family at its published width and depth in bfloat16
    (seeded random weights; a whisper model also seeded random frames; a
    llava model's prompts LM_PROMPT tokens past its patches, which the
    serve path feeds as zeros): the serve path and its decode trace as
    the lm phase runs them (`_serve_and_trace`).  A family whose weights
    would not leave LM_FAMILY_HEADROOM free on the card, or one listed in
    LM_FAMILY_LAYERS, runs at fewer layer groups (`_fit_depth`, printed
    as "depth_cut").  Then, at full width and the depth of one layer
    group (whisper: one encoder layer), in float32: prefill on the card
    against the CPU with its TF32 control (llava: 2 prompts, seeded
    random patches), decode_step against forward (a MoE at the no-drop
    capacity E/k, since decode and forward route different token
    counts); a MoE's expert ids on the card against the CPU, as
    `moe.route` returned them in those float32 prefills, and their share
    of dropped slots at the config's capacity; whisper's serve pass
    again with the zero frames the reference CLI feeds (the encoder then
    outputs zeros and the cross attention adds nothing, so its tokens
    must differ)."""
    import dataclasses

    import torch
    from repro_torch import configs
    from repro_torch.launch.serve import serve_requests
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T

    t_phase = time.perf_counter()
    cfg, depth_cut = _fit_depth(configs.get_config(arch),
                                LM_FAMILY_LAYERS.get(arch))
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    params = T.init_params(cfg, gen, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = list(_leaves(params))
    rng = np.random.default_rng(seed + 1)
    prompt = LM_PROMPT + (cfg.num_patches if cfg.frontend == "patches"
                          else 0)
    prompts = rng.integers(0, cfg.vocab_size, (LM_REQUESTS, prompt))
    frames = None
    if cfg.frontend == "frames":
        frames = torch.randn((LM_REQUESTS, cfg.encoder_seq, cfg.d_model),
                             generator=gen, device=dev).to(torch.bfloat16)

    served = _serve_and_trace(cfg, params, prompts, dev, frames)
    out = {"phase": "lm_family", "arch": cfg.name, "family": cfg.family,
           "dtype": cfg.dtype, "layers": cfg.num_layers,
           "depth_cut": depth_cut, "d_model": cfg.d_model,
           "params": sum(a.numel() for a in leaves),
           "param_bytes": sum(a.numel() * a.element_size() for a in leaves),
           "init_s": init_s, "requests": LM_REQUESTS, "batch": LM_BATCH,
           "prompt": prompt, "gen": LM_GEN,
           "prefill_s": served["out"]["prefill_s"],
           "decode_s": served["out"]["decode_s"],
           **{k: served[k] for k in ("wall_s", "tokens_per_s",
                                     "decode_tokens_per_s", "finite",
                                     "peak_mem_bytes", "decode_step_ms",
                                     "decode_trace")}}

    f32, p32 = _reduced_depth(cfg, params)
    # a patches model's 608-token prompts: 2 of them on the CPU side
    n32 = 2 if cfg.frontend == "patches" else LM_BATCH
    toks = torch.as_tensor(prompts[:n32], dtype=torch.int32)
    inputs = {"tokens": toks}
    if frames is not None:
        inputs["frames"] = frames[:n32].float().cpu()
    if cfg.frontend == "patches":
        inputs["patches"] = torch.randn(
            (n32, cfg.num_patches, cfg.d_model),
            generator=torch.Generator().manual_seed(seed + 2))
    routes, rstop = record_routes()
    try:
        out["f32_card_vs_cpu"] = {"layers": f32.num_layers,
                                  **_f32_card_vs_cpu(f32, p32, inputs)}
    finally:
        rstop()
    dec_cfg = f32
    if cfg.num_experts:
        dec_cfg = dataclasses.replace(
            f32, capacity_factor=cfg.num_experts / cfg.experts_per_token)
    dec_errs = _decode_vs_forward(dec_cfg, p32, {k: v.to(dev)
                                                 for k, v in inputs.items()})
    out["f32_decode_vs_forward"] = {
        "layers": f32.num_layers, "max_abs_err": dec_errs,
        "tolerance_abs": LM_DECODE_TOL,
        "capacity_factor": dec_cfg.capacity_factor}
    if cfg.num_experts:
        # the prefills ran on the card in float32, with TF32, then on the
        # CPU, each routing once a MoE block
        L = len(routes) // 3
        card, cpu = routes[:L], routes[2 * L:]
        T_ = card[0].shape[0]
        C = MOE._capacity(cfg, T_)
        keep = torch.stack([MOE._dispatch(ids, cfg.num_experts, C)[1]
                            for ids in card])
        out["moe"] = {"blocks": L, "tokens": T_, "capacity": C,
                      "capacity_factor": cfg.capacity_factor,
                      "expert_ids_equal_share": float(np.mean(
                          [(a.cpu() == b).float().mean().item()
                           for a, b in zip(card, cpu)])),
                      "dropped_slot_share": float(
                          1.0 - keep.float().mean())}
    del p32
    if frames is not None:
        zero = serve_requests(cfg, params, prompts, batch=LM_BATCH,
                              gen=LM_GEN)
        out["zero_frames"] = {
            "finite": bool(torch.isfinite(zero["logits"].float()).all()),
            "tokens_equal_share_vs_random_frames": float(np.mean(
                zero["tokens"] == served["out"]["tokens"]))}
    del params, leaves, frames
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    _require_lm(served, out["f32_card_vs_cpu"], dec_errs)
    if cfg.num_experts:
        require(len(routes) == 3 * out["moe"]["blocks"] > 0,
                f"moe.route calls in the three prefills: {len(routes)}")
        require(out["moe"]["expert_ids_equal_share"] > 0.99,
                f"expert ids, card vs CPU: {out['moe']}")
    if "zero_frames" in out:
        z = out["zero_frames"]
        require(z["finite"] and z["tokens_equal_share_vs_random_frames"] < 1,
                f"zero frames: {z}")
    return out


def _grads_card_vs_cpu(cfg, params, batch) -> dict:
    """float32 loss_fn and its gradients on the card (`params` there)
    against the same on the CPU, and the card's with TF32 matmuls (the
    control): the loss's relative error and the gradients' relative
    global norm of the difference, ||g_card - g_cpu|| / ||g_cpu||."""
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.train import train_lib as TL

    def norm(tree):
        return float(torch.sqrt(sum(torch.sum(g.double().cpu() ** 2)
                                    for g in _leaves(tree))))

    def diff(loss, grads):
        return {"loss_rel_err": abs(float(loss) - float(want_loss))
                / abs(float(want_loss)),
                "grad_rel_norm": norm(T.map_params(
                    lambda a, b: a.cpu() - b, grads, want)) / norm(want)}

    dev = next(_leaves(params)).device
    on_dev = {k: v.to(dev) for k, v in batch.items()}
    got = TL.value_and_grad(cfg, params, on_dev)
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = TL.value_and_grad(cfg, params, on_dev)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was
    want_loss, want = TL.value_and_grad(
        cfg, T.map_params(lambda a: a.cpu(), params), batch)
    return {"loss": float(want_loss), **diff(*got),
            "tf32_control": diff(*tf32), "tolerance_rel": TRAIN_F32_REL_TOL}


def phase_train(dev) -> dict:
    """The training path (`train/`, `launch/train.py`, the train_lm
    example) on the card:
    (a) smollm-360m's published config (bf16 weights, f32 moments, remat
        per layer group) for TRAIN_FULL_STEPS AdamW steps at TRAIN_BATCH
        x TRAIN_SEQ on the synthetic stream through train_lib: each
        step's loss, lr, grad norm and wall, tokens/s, peak memory; one
        more step under torch.profiler (kernels a step, device busy
        share, the host's top operations);
    (b) the reference driver's documented run, `launch/train.main` on
        train_100m (float32) for TRAIN_STEPS steps: the loss must fall
        (tests/test_training.py's criterion, TRAIN_LOSS_MARGIN);
    (c) the same run with --fail-at-step TRAIN_FAIL_AT and checkpoints
        every TRAIN_CKPT_EVERY steps (under build/, removed after), then
        --resume auto: every loss within TRAIN_RESUME_RTOL of (b)'s;
    (d) float32 loss and gradients at smollm-360m's width and one layer,
        card against CPU, under TRAIN_F32_REL_TOL, the TF32 control
        above it;
    (e) the train_lm example at TRAIN_EXAMPLE_STEPS steps (midpoint
        checkpoint, resumed to the end): its loss must fall.
    No kernel of the four lies on this path (its products are PyTorch
    matmuls, as the reference's are XLA's); the launch counts are read
    around it all the same."""
    import dataclasses

    import torch
    from repro_torch import configs
    from repro_torch.examples import train_lm
    from repro_torch.kernels import _build
    from repro_torch.launch import train as LT
    from repro_torch.models import transformer as T
    from repro_torch.train import data as DATA
    from repro_torch.train import optimizer as OPT
    from repro_torch.train import train_lib as TL
    from torch.profiler import ProfilerActivity, profile

    t_phase = time.perf_counter()
    _build.reset_launch_counts()
    out: dict = {"phase": "train"}

    # ---- (a) the published config at full width -------------------------
    cfg = configs.get_config(TRAIN_ARCH)
    tcfg = TL.TrainConfig(opt=OPT.OptimizerConfig(
        warmup_steps=2, total_steps=TRAIN_FULL_STEPS + 1))
    dcfg = DATA.DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                           global_batch=TRAIN_BATCH, seed=SEED)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = TL.init_state(cfg, tcfg, torch.Generator(device=dev).manual_seed(
        SEED + 90), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    step_fn = TL.make_train_step(cfg, tcfg)
    batches = [{k: v.to(dev) for k, v in b.items()} for _, b in
               zip(range(TRAIN_FULL_STEPS + 1), DATA.batches(dcfg))]
    steps = []
    for b in batches[:-1]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, b)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        steps.append({"loss": loss, "lr": float(m["lr"]),
                      "grad_norm": float(m["grad_norm"]),
                      "s": time.perf_counter() - t0})
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = step_fn(state, batches[-1])
        float(m["loss"])
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    trace = _device_summary(prof, prof_wall, top=8)
    host_ops = sorted(prof.key_averages(),
                      key=lambda e: -e.self_cpu_time_total)
    n_params = sum(a.numel() for a in _leaves(state.params))
    matmul_params = n_params - cfg.vocab_size * cfg.d_model  # no lookup
    step_s = float(np.median([st["s"] for st in steps[1:]]))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    # forward 2, backward 4 and the remat forward 2 FLOP per matmul
    # parameter and token (attention scores not counted)
    flop = 8 * matmul_params * tokens
    out["full"] = {
        "arch": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
        "param_dtype": cfg.param_dtype, "remat": cfg.remat,
        "params": n_params, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
        "init_s": init_s, "steps": steps, "median_step_s": step_s,
        "tokens_per_s": tokens / step_s, "peak_mem_bytes": peak,
        "model_flop_per_step": flop,
        "bf16_bound_ms": flop / BF16_TC_FLOP_PER_S * 1e3,
        "finite": all(np.isfinite(st["loss"]) for st in steps),
        "profiled_step": {
            "wall_s": prof_wall, **trace,
            "host_ms_by_op": {e.key[:60]: {"count": e.count,
                                           "self_ms":
                                           e.self_cpu_time_total / 1e3}
                              for e in host_ops[:8]}}}
    del state, batches, step_fn, prof
    gc.collect()
    torch.cuda.empty_cache()
    require(out["full"]["finite"], f"non-finite loss: {steps}")
    require(trace["events"] > 0, "the training trace saw no kernel")

    # ---- (b) the reference driver's documented run ---------------------
    argv = ["--arch", TRAIN_ARCH, "--variant", "train_100m", "--batch",
            str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--steps",
            str(TRAIN_STEPS), "--log-every", "10", "--device", str(dev)]
    t0 = time.perf_counter()
    straight = LT.main(argv)
    losses = straight["losses"]
    out["driver"] = {
        "variant": "train_100m", "steps": TRAIN_STEPS,
        "seconds": time.perf_counter() - t0,
        "median_step_s": float(np.median(straight["step_s"][1:])),
        "first5_mean": float(np.mean(losses[:5])),
        "last5_mean": float(np.mean(losses[-5:])),
        "margin": TRAIN_LOSS_MARGIN, "losses": losses}
    out["driver"]["tokens_per_s"] = (TRAIN_BATCH * TRAIN_SEQ
                                     / out["driver"]["median_step_s"])
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (c) crash and resume ------------------------------------------
    ckpt = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    ck = ["--ckpt-dir", str(ckpt), "--ckpt-every", str(TRAIN_CKPT_EVERY)]
    t0 = time.perf_counter()
    crashed = None
    try:
        LT.main(argv + ck + ["--fail-at-step", str(TRAIN_FAIL_AT)])
    except RuntimeError as e:
        crashed = str(e)
    gc.collect()
    torch.cuda.empty_cache()
    resumed = LT.main(argv + ck + ["--resume", "auto"])
    start = resumed["start_step"]
    rel = (np.abs(np.array(resumed["losses"]) - np.array(losses[start:]))
           / np.abs(np.array(losses[start:])))
    out["resume"] = {
        "fail_at": TRAIN_FAIL_AT, "crashed": crashed, "start_step": start,
        "steps_run": resumed["steps_run"],
        "checkpoints_kept": sorted(p.name for p in ckpt.iterdir()),
        "ckpt_bytes": sum(f.stat().st_size for f in
                          (ckpt / f"step_{TRAIN_STEPS:08d}").iterdir()),
        "max_rel_diff": float(rel.max()), "rtol": TRAIN_RESUME_RTOL,
        "seconds": time.perf_counter() - t0}
    shutil.rmtree(ckpt, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (d) float32 card vs CPU at full width, one layer --------------
    f32 = dataclasses.replace(cfg, num_layers=cfg.group_size,
                              param_dtype="float32", dtype="float32")
    p32 = T.init_params(f32, torch.Generator(device=dev).manual_seed(
        SEED + 91), device=dev)
    batch = DATA.synthetic_batch(dataclasses.replace(
        dcfg, global_batch=TRAIN_F32_BATCH, seq_len=TRAIN_F32_SEQ), 0)
    out["f32_card_vs_cpu"] = {"layers": f32.num_layers,
                              **_grads_card_vs_cpu(f32, p32, batch)}
    del p32
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (e) the train_lm example ---------------------------------------
    t0 = time.perf_counter()
    ex = train_lm.main(["--steps", str(TRAIN_EXAMPLE_STEPS), "--device",
                        str(dev)])
    out["train_lm"] = {"steps": TRAIN_EXAMPLE_STEPS,
                       "improved": ex["improved"],
                       "first_loss": ex["resumed"]["first_loss"],
                       "last_loss": ex["resumed"]["last_loss"],
                       "resumed_from": ex["resumed"]["start_step"],
                       "seconds": time.perf_counter() - t0}
    gc.collect()
    torch.cuda.empty_cache()
    out["launches"] = dict(_build.LAUNCHES)
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)

    d, r, f = out["driver"], out["resume"], out["f32_card_vs_cpu"]
    require(d["last5_mean"] < d["first5_mean"] - TRAIN_LOSS_MARGIN,
            f"the driver's loss did not fall: {d['first5_mean']} -> "
            f"{d['last5_mean']}")
    require(crashed is not None and "injected failure" in crashed,
            f"the crash was not injected: {crashed}")
    require(start == TRAIN_FAIL_AT // TRAIN_CKPT_EVERY * TRAIN_CKPT_EVERY
            and r["steps_run"] == TRAIN_STEPS - start,
            f"resume: {r}")
    require(r["max_rel_diff"] <= TRAIN_RESUME_RTOL,
            f"the resumed losses left the uninterrupted run's: {r}")
    require(max(f["loss_rel_err"], f["grad_rel_norm"])
            <= TRAIN_F32_REL_TOL, f"float32 card vs CPU: {f}")
    require(f["tf32_control"]["grad_rel_norm"] > TRAIN_F32_REL_TOL,
            f"the TF32 control passes the float32 limit: {f}")
    require(ex["improved"], f"train_lm: {out['train_lm']}")
    return out


def _snapshot(x):
    """A tensor copied into storage of its own at the same sizes and
    strides (a broadcast operand keeps its zero stride): the span of
    storage it reads, from its first element on; any other argument as
    it is."""
    import torch
    if not isinstance(x, torch.Tensor):
        return x
    if x.numel() == 0:
        return x.clone()
    span = 1 + sum((d - 1) * st for d, st in zip(x.shape, x.stride()))
    flat = x.as_strided((span,), (1,), x.storage_offset()).clone()
    return flat.as_strided(x.shape, x.stride())


def _arg_key(x):
    """An argument as part of a call's key: a tensor by its layout, a
    sequence by its values, a ring by its identity."""
    import torch
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.stride(), str(x.dtype))
    if isinstance(x, (list, tuple, np.ndarray)):
        return tuple(np.asarray(x).ravel().tolist())
    if x is None or isinstance(x, (int, float, bool, str)):
        return x
    return id(x)


def _batch_rows(shape) -> int:
    return int(np.prod(shape[:-2]))


# each kernel wrapper with its plain version and, from its bound
# arguments, the launch counter it adds to and the launches a call makes
RECORDED_WRAPPERS = {
    "eval_coeff0_gadget": ("cmp_eval", "eval_coeff0_gadget_plain",
                           lambda a: ("eval_coeff0_gadget",
                                      len(set(np.asarray(a["sel"]).tolist()))
                                      if len(a["sel"]) and a["rows"] else 0)),
    "eval_coeff0_paper": ("cmp_eval", "eval_coeff0_paper_plain",
                          lambda a: ("eval_coeff0_paper",
                                     int(a["a1"].shape[0] > 0))),
    "negacyclic_mul": ("ntt", "negacyclic_mul_plain",
                       lambda a: ("negacyclic_mul", int(0 < _batch_rows(
                           np.broadcast_shapes(a["a"].shape,
                                               a["b"].shape))))),
    "negacyclic_mul_ntt": ("ntt", "negacyclic_mul_ntt_plain",
                           lambda a: ("negacyclic_mul_ntt",
                                      int(_batch_rows(a["a"].shape) > 0))),
    "ntt_br": ("ntt", "ntt_br_plain",
               lambda a: ("ntt_br_fwd" if a["fwd"] else "ntt_br_inv",
                          int(_batch_rows(a["x"].shape) > 0))),
}


def record_calls(names=tuple(RECORDED_WRAPPERS)) -> tuple:
    """Record every call of the kernel wrappers `names` (of
    RECORDED_WRAPPERS) until `stop()`: calls maps (wrapper, the key of
    each bound argument) to [calls, launch counter, launches a call, the
    first call's arguments, each tensor copied before the kernel ran].
    Every module reaches a kernel through its module's attribute."""
    import importlib
    import inspect
    import threading

    calls, lock, undo = {}, threading.Lock(), []
    for name in names:
        mod_name, _, launches = RECORDED_WRAPPERS[name]
        mod = importlib.import_module(f"repro_torch.kernels.{mod_name}")
        inner = getattr(mod, name)
        sig = inspect.signature(inner)

        def recorded(*args, _inner=inner, _name=name, _sig=sig,
                     _launches=launches, **kwargs):
            bound = _sig.bind(*args, **kwargs)
            bound.apply_defaults()
            arg = bound.arguments
            key = (_name, *(_arg_key(v) for v in arg.values()))
            with lock:
                if key not in calls:
                    calls[key] = [0, *_launches(arg),
                                  {k: _snapshot(v) for k, v in arg.items()}]
            res = _inner(*args, **kwargs)
            with lock:
                calls[key][0] += 1
            return res
        setattr(mod, name, recorded)
        undo.append((mod, name, inner))

    def stop():
        for mod, name, inner in undo:
            setattr(mod, name, inner)
    return calls, stop


def check_calls(calls: dict, launches: dict) -> dict:
    """Each kernel against its plain version at every distinct call
    `record_calls` recorded, on that call's own arguments, tolerance 0,
    reported by kernel and operand shapes; the recorded calls times their
    launches reconciled with the path's launch counts."""
    import importlib
    import inspect

    import torch

    eq, groups, checked = True, {}, {k: 0 for k in launches}
    for (name, *_), (n_calls, counter, per_call, arg) in calls.items():
        mod_name, plain_name, _ = RECORDED_WRAPPERS[name]
        mod = importlib.import_module(f"repro_torch.kernels.{mod_name}")
        plain = getattr(mod, plain_name)
        takes = inspect.signature(plain).parameters
        got = getattr(mod, name)(**arg)
        want = plain(**{k: v for k, v in arg.items() if k in takes})
        torch.cuda.synchronize()
        same = bool(torch.equal(got, want))
        eq &= same
        checked[counter] += n_calls * per_call
        shapes = [list(v.shape) for v in arg.values()
                  if isinstance(v, torch.Tensor)]
        g = groups.setdefault((counter, str(shapes)), {
            "kernel": counter, "shapes": shapes, "calls": 0, "distinct": 0,
            "equal": True, "max_abs_err": 0})
        g["calls"] += n_calls
        g["distinct"] += 1
        g["equal"] &= same
        g["max_abs_err"] = max(g["max_abs_err"], max_abs_err(got, want))
        del got, want
    return {"tolerance": 0, "equal": eq, "by_shape": list(groups.values()),
            "checked_launches": checked,
            "launches_reconciled": checked == launches}


def phase_examples(dev) -> dict:
    """The HADES examples on the card (`repro_torch.examples`): the
    quickstart, the range query at small rows (parts 1-5) and the trace
    smoke; each checks its answers against the plaintext and raises on a
    wrong one, the trace smoke returns its failed checks.  Launch counts
    are zeroed before and read after: each kernel of EXAMPLE_KERNELS must
    have launched.  Every kernel call is recorded (`record_calls`) and
    each distinct one held against its plain version on the examples'
    own operands, tolerance 0 (test-bfv n = 256, test-ckks n = 512),
    the checked launches reconciled with the counts."""
    import torch
    from repro_torch.examples import encrypted_range_query, quickstart
    from repro_torch.kernels import _build
    from repro_torch.tools import trace_smoke

    trace = ROOT / "build" / "trace_smoke.json"
    trace.parent.mkdir(exist_ok=True)
    device = ["--device", str(dev)]
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    calls, stop = record_calls()
    walls = {}
    try:
        t0 = time.perf_counter()
        qs = quickstart.main(device)
        walls["quickstart_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        erq = encrypted_range_query.main(device + [
            "--rows", str(EXAMPLE_ROWS),
            "--index-rows", str(EXAMPLE_ROWS // 4),
            "--shard-rows", str(EXAMPLE_ROWS)])
        walls["range_query_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ts = trace_smoke.run(device + ["--out", str(trace)])
        torch.cuda.synchronize()
        walls["trace_smoke_s"] = time.perf_counter() - t0
    finally:
        stop()
    launches = dict(_build.LAUNCHES)
    checked = check_calls(calls, launches)
    del calls
    torch.cuda.empty_cache()
    out = {"phase": "examples", "quickstart": qs, "range_query": erq,
           "range_query_rows": EXAMPLE_ROWS,
           "trace_smoke": {k: ts[k] for k in ("errors", "events", "batch")},
           "walls": walls, "launches": launches, "kernels_vs_plain": checked}
    emit(out)
    require(not ts["errors"], f"trace smoke: {ts['errors']}")
    require(all(launches[k] > 0 for k in EXAMPLE_KERNELS),
            f"a kernel never launched in the examples: {launches}")
    require(checked["equal"], "a kernel != plain at an example's call")
    require(checked["launches_reconciled"],
            f"launches {launches} != the checked calls "
            f"{checked['checked_launches']}")
    return out


def start_dryrun() -> list:
    """Start the dry-run of the DRYRUN_GROUPS cells on both meshes, one
    process per group (`python -m repro_torch.launch.dryrun`, records
    under build/dryrun), at the lowest CPU priority: they trace on the
    host while the card's phases run.  Returns the processes."""
    import os
    out = ROOT / "build" / "dryrun"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    procs = []
    for i, group in enumerate(DRYRUN_GROUPS):
        code = "from repro_torch.launch import dryrun as D\n" + "".join(
            f"D.main(['--arch', {a!r}, '--shape', {sh!r}, '--both-meshes', "
            f"'--out', {str(out)!r}])\n" for a, sh in group)
        log = open(out / f"group{i}.log", "w")
        procs.append((group, log, subprocess.Popen(
            ["nice", "-n", "19", sys.executable, "-c", code], cwd=ROOT,
            env=env, stdout=log, stderr=subprocess.STDOUT)))
    return procs


def stop_dryrun(procs) -> None:
    for _, log, proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()


def _card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def phase_parallel(dev, rate, dryrun_procs, train) -> dict:
    """The parallel substrate (`parallel/`, `launch/{mesh,dryrun,report}`):
    (a) the hades-cmp cell's per-device program on the card at every
        HADES shape on both meshes (b_dev = 1,024 - 32,768 paper-bfv
        gadget lanes, `run_hades_cell(..., execute=True)`): wall, peak
        memory, the dry-run's memory estimate and roofline step time;
        every gadget Eval shape it gave the kernel held against the
        plain version (tolerance 0), launches reconciled;
    (b) the dry-run's cells (`start_dryrun`, on the host): every cell
        [ok] on both meshes, each per-device peak and the report's
        roofline tables (estimates for an H100 cluster, not
        measurements);
    (c) the one-rank mesh `launch/train` now builds (`make_host_mesh`,
        a one-rank NCCL group from a file:// store): the train phase's
        (a) steps again under it, losses bit-equal; the reduced smollm
        and deepseek-moe forward under it equal to the plain forward."""
    import torch
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.core.encrypt import Ciphertext
    from repro_torch.core.keys import keygen
    from repro_torch.core.params import make_params
    from repro_torch.core.sampling import make_generator, uniform_poly
    from repro_torch.kernels import _build
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import report as REP
    from repro_torch.launch.mesh import HBM_BYTES, make_host_mesh
    from repro_torch.models import transformer as T
    from repro_torch.parallel.constrain import use_mesh
    from repro_torch.train import data as DATA
    from repro_torch.train import optimizer as OPT
    from repro_torch.train import train_lib as TL

    t_phase = time.perf_counter()
    card = _card()
    out: dict = {"phase": "parallel", "card": card}

    # ---- (a) the HADES cells' per-device programs ----------------------
    params = make_params("paper-bfv", mode="gadget")
    ks = keygen(params, SEED + 110, device=dev)
    src = make_generator(SEED + 111, dev)
    source = Ciphertext(uniform_poly(params, src, (4096,)),
                        uniform_poly(params, src, (4096,)))
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    shapes, stop = record_gadget_shapes()
    runs = []
    try:
        for shape in D.HADES_SHAPES:
            for multi_pod in (False, True):
                rec = D.run_hades_cell(shape, multi_pod, execute=True, ks=ks,
                                       seed=SEED + 112 + len(runs))
                ex = rec["execute"]
                runs.append({
                    "shape": shape, "mesh": rec["mesh"], "lanes": ex["lanes"],
                    "wall_s": ex["wall_s"],
                    "peak_mem_bytes": ex["peak_mem_bytes"],
                    "peak_above_start_bytes": ex["peak_above_start_bytes"],
                    "estimate_bytes": rec["memory"]["peak_bytes"],
                    "step_time_s": rec["roofline"]["step_time_s"],
                    "dominant": rec["roofline"]["dominant"],
                    "launches": ex["launches"]["eval_coeff0_gadget"],
                    "output_ok": ex["output_ok"], "card": card})
                print(json.dumps({"hades_cell": runs[-1]}), flush=True)
    finally:
        stop()
    launches = dict(_build.LAUNCHES)
    calls = sum(c for c, _ in shapes.values())
    checked = check_gadget_shapes(ks, source, shapes, SEED + 113, rate)
    big = max(checked["shapes"], key=lambda sh: sh["rows"])
    if "plain_ms" not in big:
        from repro_torch.kernels import cmp_eval as CK
        g = make_generator(SEED + 114, dev)
        pick = torch.randint(0, 4096, (2 * big["rows"],), generator=g,
                             device=dev)
        K, n = params.num_towers, params.n
        u0 = source.c0[pick[:big["rows"]]].view(1, big["rows"], K, n)
        u1 = source.c1[pick[:big["rows"]]].view(1, big["rows"], K, n)
        b0 = source.c0[pick[big["rows"]:]].view(1, big["rows"], K, n)
        b1 = source.c1[pick[big["rows"]:]].view(1, big["rows"], K, n)
        big["plain_ms"] = time_cuda(lambda: CK.eval_coeff0_gadget_plain(
            u0, u1, 0, big["rows"], np.zeros(1, np.int64), b0, b1,
            ks.cek_rev, ks.ring.q_arr[:, 0], params.scale,
            params.profile.gadget_log_base), 1)
        del u0, u1, b0, b1, pick
    out["hades"] = {"runs": runs, "gadget_shapes": checked,
                    "launches": launches, "recorded_calls": calls,
                    "launches_reconciled":
                    calls == launches["eval_coeff0_gadget"],
                    "largest": big}
    del ks, source
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (c) the one-rank mesh -----------------------------------------
    store = ROOT / "build" / "pg_store"
    store.unlink(missing_ok=True)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        mesh = make_host_mesh()
        cfg = configs.get_config(TRAIN_ARCH)
        tcfg = TL.TrainConfig(opt=OPT.OptimizerConfig(
            warmup_steps=2, total_steps=TRAIN_FULL_STEPS + 1))
        dcfg = DATA.DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                               global_batch=TRAIN_BATCH, seed=SEED)
        with use_mesh(mesh):
            state = TL.init_state(cfg, tcfg, torch.Generator(
                device=dev).manual_seed(SEED + 90), device=dev)
            step_fn = TL.make_train_step(cfg, tcfg)
            losses = []
            for _, b in zip(range(TRAIN_FULL_STEPS), DATA.batches(dcfg)):
                state, m = step_fn(state, {k: v.to(dev)
                                           for k, v in b.items()})
                losses.append(float(m["loss"]))
        del state, step_fn
        plain_losses = [st["loss"] for st in train["full"]["steps"]]
        forwards = {}
        for i, arch in enumerate(MESH_FORWARD_ARCHS):
            rcfg = configs.get_reduced(arch)
            p = T.init_params(rcfg, torch.Generator(device=dev).manual_seed(
                SEED + 120 + i), device=dev)
            tokens = torch.randint(
                0, rcfg.vocab_size, (4, 32), device=dev,
                generator=torch.Generator(device=dev).manual_seed(SEED + 130))
            want = T.forward(rcfg, p, {"tokens": tokens})
            with use_mesh(mesh):
                got = T.forward(rcfg, p, {"tokens": tokens})
            forwards[arch] = bool(torch.equal(got, want))
        out["mesh"] = {"shape": list(mesh.shape),
                       "names": list(mesh.mesh_dim_names),
                       "losses": losses, "plain_losses": plain_losses,
                       "losses_equal": losses == plain_losses,
                       "forward_equal": forwards}
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (b) the dry-run on the host -----------------------------------
    t0 = time.perf_counter()
    cells = {}
    for group, log, proc in dryrun_procs:
        try:
            proc.wait(timeout=max(1.0, DRYRUN_LIMIT_S
                                  - (time.perf_counter() - t_phase)))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        log.flush()
        text = Path(log.name).read_text()
        for line in text.splitlines():
            if line.startswith("[ok]") or line.startswith("[FAIL]"):
                print(line, flush=True)
        if proc.returncode:
            print(text[-4000:], flush=True)
        cells[" ".join(f"{a}/{sh}" for a, sh in group)] = {
            "rc": proc.returncode, "ok_lines": text.count("[ok]")}
    recs = REP.load(str(ROOT / "build" / "dryrun"))
    peaks = {f"{a}/{sh}/{m}": r["memory"]["peak_per_device_gib"]
             for (a, sh, m), r in sorted(recs.items())
             if r["status"] == "ok"}
    for mesh_name in REP.MESHES:
        print(f"dry-run roofline (estimates for an H100 cluster, traced; "
              f"mesh {mesh_name}):", flush=True)
        print(REP.roofline_table(recs, mesh_name), flush=True)
    want = 2 * sum(len(g) for g in DRYRUN_GROUPS)
    out["dryrun"] = {"groups": cells, "records": len(recs),
                     "ok": sum(r["status"] == "ok" for r in recs.values()),
                     "expected": want, "peak_per_device_gib": peaks,
                     "over_80gb": [k for k, v in peaks.items()
                                   if v * 2**30 > HBM_BYTES],
                     "wait_s": time.perf_counter() - t0}
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    h = out["hades"]
    require(h["gadget_shapes"]["equal"],
            "the gadget Eval != plain at a HADES cell's shape")
    require(h["launches_reconciled"],
            f"HADES launches {h['launches']} != recorded calls {calls}")
    require(all(r["output_ok"] and r["launches"] >= 1
                and r["peak_mem_bytes"] <= HBM_BYTES for r in runs),
            f"a HADES cell failed or did not fit: {runs}")
    require(all(c["rc"] == 0 for c in cells.values()),
            f"a dry-run group failed: {cells}")
    require(out["dryrun"]["ok"] == want and len(recs) == want,
            f"dry-run cells not [ok]: {out['dryrun']}")
    require(out["mesh"]["losses_equal"],
            f"losses under the one-rank mesh differ: {out['mesh']}")
    require(all(forwards.values()),
            f"a forward under the one-rank mesh differs: {forwards}")
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "__init__.py").exists():
        print(f"chip_smoke: {SRC / 'repro_torch'} is missing: run from a "
              "checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    t_start = time.perf_counter()
    if sys.argv[1:] == ["--shard-phases"]:
        return _main_shard(t_start)
    if sys.argv[1:] == ["--ckks-phases"]:
        return _main_ckks(t_start)
    if sys.argv[1:] == ["--fae-phases"]:
        return _main_fae(t_start)
    if sys.argv[1:]:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]} (the options "
              "are --shard-phases, --ckks-phases and --fae-phases)",
              file=sys.stderr)
        return 2
    dryrun = start_dryrun()
    try:
        return _main(t_start, dryrun)
    finally:
        stop_dryrun(dryrun)


def _placement_summary(placement: dict) -> dict:
    """Each placed run's mesh, walls, peaks and checks, by mesh name."""
    return {r["mesh"]: {
        "d": r["d"], "cards": r["cards"], "walls": r["walls"],
        "peak_mem_bytes": r["peak_mem_bytes"],
        **{k: r[k] for k in ("raw_equal", "answers_equal", "truth_ok",
                             "join_exact", "sort_merge_exact",
                             "paper_scan_exact", "launches_reconciled")}}
        for r in placement["runs"]}


def _loop_shard_summary(out: dict) -> dict:
    """Phase 11a's checks across layouts, and each layout's walls,
    point latencies, rates, compaction and peaks."""
    return {"layouts_equal": out["layouts_equal"],
            "four_cards": out["four_cards"],
            "runs": {name: {k: r[k] for k in (
                "d", "exact", "plain_equal", "p99_vs_isolated",
                "point_isolated_ms", "point_mixed_ms", "steady_qps",
                "inserts_per_s", "peak_mem_bytes", "stale_bytes",
                "launches_reconciled")}
                | {"compaction_s": [c["s"] for c in r["compaction"]],
                   "busy_share": r["busy"]["busy_share"]}
                for name, r in out["runs"].items()}}


def _print_card_and_device(kernels=None) -> None:
    """The card's name and power limit (nvidia-smi), the {"kernels":
    [...]} line when given its rows, then the device record, the last
    line."""
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    if kernels is not None:
        emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


def _main_shard(t_start: float) -> int:
    """`python3 chip_smoke.py --shard-phases`: the build, then phases 9,
    10, 10b and 11a alone (shard, join with its layouts, placement, the
    serving loop in front of a sharded table) on the keys the serve and
    write phases make (11a makes its own), so that the placed runs can
    be measured on a machine with several cards (mesh (a) then spans
    every visible card, and 11a runs its layout (c)).  Ends with the
    card line and the device record."""
    import torch
    from repro_torch.core.keys import keygen
    from repro_torch.core.params import make_params
    from repro_torch.data import load_dataset
    dev = torch.device("cuda", 0)
    print(json.dumps({"phase": "start", "mode": "shard-phases",
                      "torch": torch.__version__, "cuda": torch.version.cuda,
                      "python": sys.version.split()[0],
                      "device_count": torch.cuda.device_count()}),
          flush=True)
    phase_build()
    rate = int_mac_rate()
    params = make_params(PROFILE, mode="gadget")
    vals = load_dataset("hg38", scheme="bfv", t=params.t)
    ks = keygen(params, SEED, device=dev)
    wks = keygen(make_params(PROFILE, mode="paper"), SEED + 20, device=dev,
                 paper_ecek_weight=0)
    shard, shard_base = phase_shard(ks, vals, rate)
    gc.collect()
    torch.cuda.empty_cache()
    *cut, join = phase_join(ks, wks, vals, rate)
    layouts = phase_layouts(ks, wks, *cut, rate)
    placement = phase_placement(ks, wks, vals, *cut, shard_base, join, rate)
    del cut, ks, wks, shard_base
    gc.collect()
    torch.cuda.empty_cache()
    loop_shard = phase_loop_shard(dev, rate)
    emit({"phase": "done", "mode": "shard-phases",
          "seconds": time.perf_counter() - t_start,
          "shard": {k: shard[k] for k in ("correct", "walls",
                                          "peak_mem_bytes")},
          "join": {"walls": join["walls"]},
          "layouts_equal": layouts["equal"],
          "placement": _placement_summary(placement),
          "loop_shard": _loop_shard_summary(loop_shard)})
    _print_card_and_device()
    return 0


def _ckks_summary(ckks: dict) -> dict:
    """The float path's answers, checks, walls, rates and peak memory."""
    return {"exact": ckks["exact"],
            "shapes_equal": ckks["gadget_shapes"]["equal"]
            and ckks["mul_shapes"]["equal"] and ckks["ntt_calls"]["equal"],
            **{k: ckks[k] for k in ("launches_reconciled", "walls",
                                    "queries_per_s", "inserts_per_s",
                                    "peak_mem_bytes", "peaks")}}


def _ckks_shard_summary(shard: dict) -> dict:
    """The sharded float phase's checks, and each layout's walls, rates
    and peaks."""
    return {**{k: shard[k] for k in ("exact", "raw_equal", "answers_equal",
                                     "four_cards", "seconds")},
            "runs": {layout: {k: r[k] for k in (
                "d", "shapes_equal", "launches_reconciled", "walls",
                "queries_per_s", "inserts_per_s", "peak_mem_bytes")}
                | {"loop": {k: r["loop"][k] for k in (
                    "inserts_per_s", "compaction")}}
                for layout, r in shard["runs"].items()}}


def _ckks_rows(ckks: dict, engine: str = "db",
               profile: str = CKKS_PROFILE) -> list:
    """A path's kernel rows for the card line: each kernel the path
    launched at its most-called shape whose plain version was timed,
    named with the profile and the engine ("@paper-ckks/db", the sharded
    tables' "@paper-ckks/shard", the FAE tables' "@paper-bfv/fae" and
    "@paper-ckks/fae")."""
    src = "src/repro_torch/kernels/csrc"

    def row(name, source, replaces, shapes):
        top = max((s for s in shapes if "plain_ms" in s),
                  key=lambda s: s["calls"])
        return {"name": f"{name}@{profile}/{engine}", "route": "cuda",
                "source": f"{src}/{source}", "replaces": replaces,
                "launches": ckks["launches"][name],
                "max_abs_err": max(s.get("max_abs_err", 0) for s in shapes),
                "ms": top["ms"], "plain_ms": top["plain_ms"],
                "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
                "library_ms": None}
    muls = ckks["mul_shapes"]["shapes"]
    ntt = ckks["ntt_calls"]
    ntt_err = max((g["max_abs_err"] for g in ntt["by_shape"]), default=0)
    rows = [
        ("eval_coeff0_gadget", "cmp_eval.cu",
         "src/repro/kernels/cmp_eval.py:48", ckks["gadget_shapes"]["shapes"]),
        ("negacyclic_mul_ntt", "ntt.cu", "src/repro/kernels/ntt.py:81",
         [s for s in muls if s["kind"] == "key"]),
        ("negacyclic_mul", "ntt.cu", "src/repro/kernels/ntt.py:81",
         [s for s in muls if s["kind"] == "var"]),
        ("ntt_br_fwd", "ntt.cu", "src/repro/kernels/ntt.py:68",
         [t for t in ntt["timed"] if t["kernel"] == "ntt_br_fwd"])]
    return [{**row(*r), **({"max_abs_err": ntt_err}
                           if r[0] == "ntt_br_fwd" else {})}
            for r in rows if ckks["launches"][r[0]]]


def _main_ckks(t_start: float) -> int:
    """`python3 chip_smoke.py --ckks-phases`: the build, then the float
    phases (11b, and 11c on its keys) alone.  Ends with the card line,
    the float phases' kernel rows and the device record."""
    import torch
    dev = torch.device("cuda", 0)
    print(json.dumps({"phase": "start", "mode": "ckks-phases",
                      "torch": torch.__version__, "cuda": torch.version.cuda,
                      "python": sys.version.split()[0]}), flush=True)
    phase_build()
    rate = int_mac_rate()
    ckks, ckks_base = phase_ckks(dev, rate)
    gc.collect()
    torch.cuda.empty_cache()
    shard = phase_ckks_shard(ckks_base, rate)
    gc.collect()
    torch.cuda.empty_cache()
    fae_b = phase_fae_ckks(ckks_base["ks"], rate)
    del ckks_base
    emit({"phase": "done", "mode": "ckks-phases",
          "seconds": time.perf_counter() - t_start,
          "ckks": _ckks_summary(ckks),
          "ckks_shard": _ckks_shard_summary(shard),
          "fae": {"b": _fae_summary(fae_b)}})
    _print_card_and_device(_ckks_rows(ckks)
                           + _ckks_rows(shard["kernel_run"], "shard")
                           + _ckks_rows(fae_b, "fae"))
    return 0


def _fae_summary(fae: dict) -> dict:
    """A FAE part's checks, walls, rates, peaks and F2 figures."""
    return {k: fae[k] for k in (
        "exact", "shapes_equal", "launches_reconciled", "walls",
        "queries_per_s", "inserts_per_s", "peak_mem_bytes", "peaks", "f2",
        "key_noise", "differ_from_plain") if k in fae}


def _main_fae(t_start: float) -> int:
    """`python3 chip_smoke.py --fae-phases`: the build, then the FAE
    parts alone: (a) on paper-bfv gadget keys made as the serve phase
    makes them, over full hg38; (b) on paper-ckks gadget keys made as the
    float phase makes them.  Ends with the card line, the parts' kernel
    rows and the device record."""
    import torch
    from repro_torch.core.keys import keygen
    from repro_torch.core.params import make_params
    from repro_torch.data import load_dataset
    dev = torch.device("cuda", 0)
    print(json.dumps({"phase": "start", "mode": "fae-phases",
                      "torch": torch.__version__, "cuda": torch.version.cuda,
                      "python": sys.version.split()[0]}), flush=True)
    phase_build()
    rate = int_mac_rate()
    params = make_params(PROFILE, mode="gadget")
    vals = load_dataset("hg38", scheme="bfv", t=params.t)
    fae_a = phase_fae(keygen(params, SEED, device=dev), vals, rate)
    gc.collect()
    torch.cuda.empty_cache()
    fae_b = phase_fae_ckks(keygen(make_params(CKKS_PROFILE, mode="gadget"),
                                  SEED + 60, device=dev), rate)
    emit({"phase": "done", "mode": "fae-phases",
          "seconds": time.perf_counter() - t_start,
          "fae": {"a": _fae_summary(fae_a), "b": _fae_summary(fae_b)}})
    _print_card_and_device(_ckks_rows(fae_a, "fae", PROFILE)
                           + _ckks_rows(fae_b, "fae"))
    return 0


def _main(t_start: float, dryrun: list) -> int:
    import torch
    dev = torch.device("cuda", 0)
    print(json.dumps({"phase": "start", "torch": torch.__version__,
                      "cuda": torch.version.cuda,
                      "python": sys.version.split()[0]}), flush=True)

    phase_build()
    rate = int_mac_rate()
    ks, table, vals, reqs, serve = phase_serve(dev)
    kern = phase_kernels(ks, table, serve, rate)
    phase_profile(ks, table, reqs, serve)
    phase_index(ks, table, vals)
    keymul = phase_keymul(ks, table, rate)
    del table, reqs                 # free the gadget table for the write path
    gc.collect()
    torch.cuda.empty_cache()
    wks, wtable, write = phase_write(dev, vals)
    paper = phase_paper(wks, wtable, write, rate)
    del wtable                      # and the write table for the FAE path
    gc.collect()
    torch.cuda.empty_cache()
    fae_a = phase_fae(ks, vals, rate)
    gc.collect()
    torch.cuda.empty_cache()
    shard, shard_base = phase_shard(ks, vals, rate)
    gc.collect()
    torch.cuda.empty_cache()
    *cut, join = phase_join(ks, wks, vals, rate)
    layouts = phase_layouts(ks, wks, *cut, rate)
    placement = phase_placement(ks, wks, vals, *cut, shard_base, join, rate)
    del cut, ks, wks, shard_base
    gc.collect()
    torch.cuda.empty_cache()
    loop = phase_loop(dev, rate)
    gc.collect()
    torch.cuda.empty_cache()
    loop_shard = phase_loop_shard(dev, rate)
    gc.collect()
    torch.cuda.empty_cache()
    ckks, ckks_base = phase_ckks(dev, rate)
    gc.collect()
    torch.cuda.empty_cache()
    ckks_shard = phase_ckks_shard(ckks_base, rate)
    gc.collect()
    torch.cuda.empty_cache()
    fae_b = phase_fae_ckks(ckks_base["ks"], rate)
    del ckks_base
    gc.collect()
    torch.cuda.empty_cache()
    lm = phase_lm(dev, rate)
    gc.collect()
    torch.cuda.empty_cache()
    families = [phase_lm_family(dev, arch, SEED + 50 + 10 * i)
                for i, arch in enumerate(LM_FAMILIES)]
    train = phase_train(dev)
    parallel = phase_parallel(dev, rate, dryrun, train)
    examples = phase_examples(dev)
    emit({"phase": "done", "seconds": time.perf_counter() - t_start,
          **{k: serve[k] for k in ("correct", "keygen_s", "encrypt_s",
                                   "serve_wall_s", "queries_per_s",
                                   "peak_mem_bytes")},
          "write": {k: write[k] for k in ("inserts_per_s", "exact",
                                          "scan_correct", "walls",
                                          "peak_mem_bytes")},
          "shard": {k: shard[k] for k in ("correct", "topk_ok",
                                          "scan_ratio", "merge_compares",
                                          "walls", "peak_mem_bytes")},
          "placement": _placement_summary(placement),
          "join": {"walls": join["walls"],
                   "peak_mem_bytes": join["peak_mem_bytes"],
                   **{k: join[k]["exact"] for k in (
                       "sort_merge", "sort_merge_sharded", "nested_gadget",
                       "nested_sharded", "nested_paper")}},
          "layouts_equal": layouts["equal"],
          "loop": {k: loop[k] for k in (
              "exact", "point_isolated_ms", "point_mixed_ms",
              "p99_vs_isolated", "bulk_mixed_ms", "union_read_ms",
              "steady_qps", "shed_rate", "jit_retraces_delta",
              "threaded_exact", "overload", "index_build_s",
              "peak_mem_bytes", "launches_reconciled")},
          "loop_shard": _loop_shard_summary(loop_shard),
          "ckks": _ckks_summary(ckks),
          "ckks_shard": _ckks_shard_summary(ckks_shard),
          "fae": {"a": _fae_summary(fae_a), "b": _fae_summary(fae_b)},
          "lm": {"tokens_per_s": lm["tokens_per_s"],
                 "prefill_s": lm["prefill_s"], "decode_s": lm["decode_s"],
                 "f32_rel_err": lm["f32_card_vs_cpu"]["rel_err"],
                 "tf32_control_rel_err": lm["f32_card_vs_cpu"][
                     "tf32_control_rel_err"],
                 "decode_busy_share": lm["decode_trace"]["busy_share"],
                 "decode_err": max(lm["f32_decode_vs_forward"][
                     "max_abs_err"]),
                 "bf16_greedy_equal_share": lm["bf16_greedy_equal_share"],
                 "topk_ok": lm["bridge"]["topk_ok"],
                 "walls": lm["bridge"]["walls"],
                 "ckks_shapes_equal": lm["gadget_shapes"]["equal"]
                 and lm["mul_shapes"]["equal"]},
          "lm_families": {f["arch"]: {
              "tokens_per_s": f["tokens_per_s"],
              "decode_step_ms": f["decode_step_ms"],
              "kernels_per_step": f["decode_trace"]["kernels_per_step"],
              "f32_rel_err": f["f32_card_vs_cpu"]["rel_err"],
              "tf32_control_rel_err": f["f32_card_vs_cpu"][
                  "tf32_control_rel_err"],
              "decode_err": max(f["f32_decode_vs_forward"]["max_abs_err"]),
              "peak_mem_bytes": f["peak_mem_bytes"],
              "depth_cut": f["depth_cut"]} for f in families},
          "train": {
              "full_step_s": train["full"]["median_step_s"],
              "full_tokens_per_s": train["full"]["tokens_per_s"],
              "full_peak_mem_bytes": train["full"]["peak_mem_bytes"],
              "driver_loss": [train["driver"]["first5_mean"],
                              train["driver"]["last5_mean"]],
              "resume_max_rel_diff": train["resume"]["max_rel_diff"],
              "f32": {k: train["f32_card_vs_cpu"][k] for k in (
                  "loss_rel_err", "grad_rel_norm")},
              "tf32_control_grad_rel_norm": train["f32_card_vs_cpu"][
                  "tf32_control"]["grad_rel_norm"],
              "train_lm_improved": train["train_lm"]["improved"]},
          "parallel": {
              "hades_walls_s": {f"{r['shape']}/{r['mesh']}": r["wall_s"]
                                for r in parallel["hades"]["runs"]},
              "hades_equal": parallel["hades"]["gadget_shapes"]["equal"],
              "hades_launches_reconciled":
              parallel["hades"]["launches_reconciled"],
              "dryrun_ok": [parallel["dryrun"]["ok"],
                            parallel["dryrun"]["expected"]],
              "mesh_losses_equal": parallel["mesh"]["losses_equal"],
              "seconds": parallel["seconds"]},
          "examples": {"launches": examples["launches"],
                       "walls": examples["walls"],
                       **{k: examples["kernels_vs_plain"][k] for k in (
                           "equal", "launches_reconciled")}}})

    src = "src/repro_torch/kernels/csrc"
    ev, mul = kern["eval"], kern["mul"]
    tile = ev["served_tiles"][0]          # the first batch's tile shape
    lanes = paper["lanes"]                # the sort stage shape

    def row(name, source, replaces, path, launches, err, t):
        return {"name": name, "route": "cuda", "source": f"{src}/{source}",
                "replaces": replaces, "launches": path["launches"][launches],
                "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": None}

    def ckks_row(name, source, replaces, checked, kind=None):
        """A kernel at LM_PROFILE: its most-called shape on the bridge
        whose plain version was timed."""
        shapes = [s for s in checked["shapes"]
                  if kind is None or s["kind"] == kind]
        top = max((s for s in shapes if "plain_ms" in s),
                  key=lambda s: s["calls"])
        return row(f"{name}@{LM_PROFILE}", source, replaces, lm, name,
                   max(s["max_abs_err"] for s in shapes), top)
    hades = parallel["hades"]
    _print_card_and_device([
        {**row("eval_coeff0_gadget@hades-cmp", "cmp_eval.cu",
               "src/repro/kernels/cmp_eval.py:48", hades,
               "eval_coeff0_gadget",
               max(sh["max_abs_err"] for sh in
                   hades["gadget_shapes"]["shapes"]), hades["largest"]),
         "lanes": hades["largest"]["rows"]},
        row("eval_coeff0_gadget", "cmp_eval.cu",
            "src/repro/kernels/cmp_eval.py:48", serve, "eval_coeff0_gadget",
            ev["max_abs_err"], tile),
        row("negacyclic_mul_ntt", "ntt.cu", "src/repro/kernels/ntt.py:81",
            serve, "negacyclic_mul_ntt", mul["max_abs_err"], mul["key_ntt"]),
        row("negacyclic_mul", "ntt.cu", "src/repro/kernels/ntt.py:81",
            serve, "negacyclic_mul", mul["max_abs_err"], mul["var"]),
        row("eval_coeff0_paper", "cmp_eval.cu",
            "src/repro/kernels/cmp_eval.py:35", write, "eval_coeff0_paper",
            paper["max_abs_err"], lanes),
        row("ntt_br_fwd", "ntt.cu", "src/repro/kernels/ntt.py:68", keymul,
            "ntt_br_fwd", keymul["max_abs_err"], keymul["fwd"]),
        row("ntt_br_inv", "ntt.cu", "src/repro/kernels/ntt.py:75", keymul,
            "ntt_br_inv", keymul["max_abs_err"], keymul["inv"]),
        ckks_row("eval_coeff0_gadget", "cmp_eval.cu",
                 "src/repro/kernels/cmp_eval.py:48", lm["gadget_shapes"]),
        ckks_row("negacyclic_mul_ntt", "ntt.cu",
                 "src/repro/kernels/ntt.py:81", lm["mul_shapes"], "key"),
        ckks_row("negacyclic_mul", "ntt.cu", "src/repro/kernels/ntt.py:81",
                 lm["mul_shapes"], "var"),
        *_ckks_rows(ckks),
        *_ckks_rows(ckks_shard["kernel_run"], "shard"),
        *_ckks_rows(fae_a, "fae", PROFILE),
        *_ckks_rows(fae_b, "fae"),
    ])
    return 0


if __name__ == "__main__":
    sys.exit(main())
