#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
1. report the card (nvidia-smi name and power limit, torch and CUDA);
2. build the kernels from ops/csrc/ with nvcc by constructing a
   CudaBatchVerifier on the card (a verifier builds and loads them when
   it is constructed, never inside a dispatch); print the build seconds,
   the compiler's register and spill report, and each kernel's SASS
   instruction mix (cuobjdump -sass: IMAD.WIDE, shuffles, shared and
   local loads, total; static counts);
3. hold each kernel against its plain PyTorch version at n = 16384 on
   the card, byte for byte: ed25519_prep (msg32 and k modes) and
   ed25519_ladder, on lanes of which a quarter the strict checks reject
   (the differential corpus's adversarial tuples and random bytes);
   hold prep's ok flags against the oracle's strict checks and the
   verdicts of prep -> ladder -> finish against the oracle, lane by
   lane; time each kernel (CUDA events, median of 25 launches after
   warm-up) beside the plain version and the integer-multiply bound
   (with the bound's products per signature) and its launch geometry
   (threads per signature, block, resident warps); print, on a line of
   its own, the static product count of each kernel's schedule, which
   the CPU tests count on the plain versions; run the v1 entry
   (host_prepare -> verify_kernel) on 2048 of the lanes against the
   oracle;
4. the differential corpus (make_differential_vectors(200)) through
   CudaBatchVerifier: 0 mismatches against the oracle;
5. the main path at width: 16384 signatures per dispatch in msg32 mode
   with 4 dispatches in flight, one 5000-signature dispatch, and one
   2048-signature host-k batch of mixed message lengths with every 10th
   tuple corrupted, checked against the oracle; the launch counters are
   set to 0 before each part and must equal its dispatch count;
6. one in-flight round under torch.profiler (after a warm-up round):
   device busy time by kernel and the device's idle share;
7. the live verify path at the node's defaults (main/config.py of the
   JAX package: max_batch 256, deadline 2 ms, device cutoff 16,
   dispatch deadline 2000 ms, canary 16):
   VerifyService(BackendSupervisor(CudaBatchVerifier())). The host
   verifier serving the bypass and the fallback must be the native
   library. Leg A, a smoke of flood admission's mechanism (the mix is
   chosen to drive both prep modes, not measured traffic): 16384 single
   submits with the clock cranked after each (90 % 32-byte tx hashes,
   10 % 100-500 byte messages, every 10th tuple corrupted), then
   drain. Leg B, a txset: 5000 msg32 signatures through
   submit_many, then awaited. In A and B: 0 verdicts off the oracle, 0
   supervisor failures, 0 service fallbacks, the breaker CLOSED
   throughout, kernel launches equal to the device dispatches. The
   fixed cost of a 16- and a 256-signature flush. Leg C, chaos on the
   card under a virtual clock: three io_error faults at
   ops.backend.dispatch trip the breaker OPEN; while OPEN flushes
   resolve natively with no dispatch and no launch; past the backoff
   the canary runs on the card and closes it; a hang with a 200 ms
   deadline resolves through the watchdog and is quarantined; an
   io_error at ops.verifier.batch is absorbed by the supervisor, and
   makes a bare service fall back;
8. the multi-device verify path. 8.1: ShardedBatchVerifier() over every
   visible card (one card: the single-survivor path) on phase 5's
   4 x 16384 in flight. 8.2: a stand-in mesh of four positions on
   cuda:0 (its shards share the card's stream and run one after
   another: not multi-card scaling) on the same round and on phase 5's
   host-k batch, then shrunk to (0, 2, 3) and (1,), a probe pinned to
   inactive position 3, and regrown; dispatch walls beside
   CudaBatchVerifier's. 8.3: the sick-device window on the card,
   VerifyService(BackendSupervisor(that stand-in mesh)) under a virtual
   clock: two io_errors at ops.backend.dispatch.device trip position 2
   alone; while it is OPEN its per-position batch count stays frozen,
   every launch belongs to a sibling's shard and its siblings serve;
   the first probe fails inside the fault window, the second closes it
   and the mesh regrows. 8.4: HybridShardedVerifier over a (2, 2) grid
   on cuda:0 in one process, then in two spawned gloo ranks with two
   positions each on one 5000-signature msg32 batch, then on it and its
   reverse in flight, collected in opposite orders on the two ranks:
   each rank's verdicts equal the oracle and each broadcasts only its
   rows' verdicts and the batch's 16-byte tag.
   Every leg: verdicts equal the oracle, launches of each kernel equal
   active shards x dispatches.
9. txset validation on the card at BASELINE.json config #2: a
   protocol-21 ledger of 10,000 funded accounts and a txset of 5000
   one-Payment transactions, one per source, signed by the native host
   library, with a chosen mix (not measured traffic): 4 % 2-of-2
   multisig (the second signature misses the batch and goes to the
   fallback), 2 % fee bumps, 1 % with one flipped signature byte,
   0.5 % with an unneeded signature. Run A: the herder's
   `_LazyBatchPrevalidator(BackendSupervisor(CudaBatchVerifier()))`
   under `ApplicableTxSet.check_valid`, a second validation with the
   cache seeded, `trim_invalid`, then the apply of the valid set in
   apply order. Run B: the same set on a fresh root from the same
   bytes through `default_verify` (native, per signature). Fails unless
   A and B agree on verdicts, trim, result bytes and the ledger hash,
   the one device batch equals the oracle and holds exactly the
   `collect_signature_tuples` pairs with prep 1 + ladder 1 launches,
   the second validation launches nothing, and the supervisor ends
   CLOSED with 0 failures and 0 skips.
10. the classic operation families on the same path at the same size:
   a ledger of 5000 sources with authorized LOAD trustlines (what the
   JAX package's load generator leaves after setup_dex) and 5000
   transactions, one per source, of its MIXED_CLASSIC and PRETEND modes
   in a chosen mix (40 % resting ManageSellOffers, about 40 % native
   payments, 15 % SetOptions + ManageData + SetOptions, 2 %
   PathPaymentStrictSend crossing the offers, 1 % CreateAccount, 1 %
   ChangeTrust, 1 % with one flipped signature byte). Runs A and B as
   phase 9's, with the same checks; besides, exactly the flipped
   transactions are dropped, only a path payment may fail at apply, at
   least one path payment crossed an offer, and every offer created
   rests after apply. It prints the results by operation type.
11. contract auth-entry signatures batched on the card (BASELINE.json
   config #4, contract-heavy ledgers), every default invariant enabled:
   a protocol-21 ledger with the initial CONFIG_SETTING entries, the
   native-asset SAC and an SCVM contract deployed by transactions, 5000
   relayers and 5000 holders; 5000 InvokeHostFunction transactions in a
   chosen mix (88 % native-SAC transfers authorized by the holder's
   address credentials, 5 % the load generator's source-account form,
   3 % an SCVM auth_bump with address credentials, 2 % a flipped auth
   signature, 1 % an expired auth entry, 1 % a flipped envelope
   signature). Run A validates and trims as phase 9 does, then verifies
   as catchup does: the kept transactions' envelope and auth-entry
   tuples in one dispatch, a PrevalidatedVerifier of its verdicts as the
   apply's verify, every verdict written through to the verify cache;
   run B the same with the native library as the batch verifier. Fails
   unless A equals B on verdicts, trim, results, contract events, the
   holders' XLM and the ledger hash; each batch holds exactly its
   collect_signature_tuples pairs and equals the oracle, false exactly
   on the flipped envelopes and the flipped auth signatures; prep msg32
   2 + ladder 2; every auth
   verify of the host's is a cache hit (0 native verifies); sac_addr,
   sac_source and scvm succeed, bad_auth and expired fail as TRAPPED
   with the fee charged and the sequence number used, flipped is
   dropped; one nonce entry and one TTL per verified address entry;
   the supervisor CLOSED with 0 failures and 0 skips.
12. wasm contracts on the same path (BASELINE.json config #4 with
   contracts in wasm, as SDK-built ones are), every default invariant
   enabled: phase 11's ledger shape with three wasm contracts
   uploaded and created by transactions (the env-ABI counter and
   toolkit of soroban/env_contract.py, the load generator's scvm_wasm
   counter); 5000 InvokeHostFunction transactions in a chosen mix
   (about 84 % env-counter auth_bump with address credentials, 8 % the
   load generator's counter increments, 3 % a contract-level
   verify_sig_ed25519 of a valid signature, 1 % of a flipped one, 2 % a
   flipped auth signature, 1 % an instructions resource one short of
   what the call needs, 1 % a flipped envelope signature). Runs A and B
   as phase 11's (`contract_runs`), with its checks; besides: contract
   events and return values equal in A and B; results by kind
   (WASM_RESULTS: the short budget ends RESOURCE_LIMIT_EXCEEDED when
   the wasm meter runs out); the verify cache during A's apply hit
   once per auth entry require_auth reached and missed exactly once per
   contract-level verify (the host verifies those natively: nothing
   batches them); nonces, the counter's value and the module cache
   holding exactly the three contracts.
13. persistence and ledger close with the staged apply's per-stage
   signature prewarm on the card (BASELINE.json config #1, standalone
   loadgen, 1000 PaymentOp transactions per ledger close): two nodes,
   each a LedgerManager over a sqlite Database and a BucketManager in a
   fresh temporary directory, genesis at protocol 21 on the standalone
   network, a close that votes maxTxSetSize 1000, closes that create
   2000 accounts (100 CreateAccount ops per transaction from the
   master, as the load generator does), then 10 measured closes of 1000
   one-Payment transactions in a chosen mix (97 % on pairs disjoint
   within the ledger, 2 % paying another transaction's destination, 1 %
   with a flipped signature byte) and one close in the load generator's
   PAY chain as the control. Run A has the node's wiring (staged apply,
   4 workers from 8 transactions; VerifyService(BackendSupervisor(
   CudaBatchVerifier())) as the manager's verify service at phase 7's
   defaults), run B no verify service. Fails unless A equals B on every
   header, result, meta and bucket level and on the final rows; a fresh
   LedgerManager reloads A's LCL from its files; every prewarm verdict
   equals the oracle; each close's stages, submits, flushes by reason,
   device dispatches and the verify cache's hits and misses are those
   its stage widths give; prep msg32 launches equal ladder launches
   equal device dispatches; the supervisor stays CLOSED with 0
   failures and 0 skips and the service with 0 fallbacks; the control
   close prewarms and launches nothing. It prints each close's wall, its
   ledger.close.* zones and the garbage collector's passes, the
   prewarm's wall and the flushes' walls.
14. catchup from a local history archive (BASELINE.json config #3,
   catchup-complete replay), each checkpoint's signatures verified on
   the card in one dispatch: a publisher node (the port's Application
   over a sqlite file and a bucket directory, with a tmpdir archive in
   its HISTORY) closes ledger 2 (the maxTxSetSize vote), 3-4 (2000
   accounts), 5-63 (10 one-Payment transactions each on disjoint pairs)
   and 64-127 (1000 one-Payment transactions each in phase 13's mix,
   staged apply) and publishes checkpoints 63 and 127 to a tmpdir
   archive through `cp`. Run A1: StreamingCatchupWork, complete (the
   node's default path); run A2: the sequential CatchupWork to ledger
   80; each on a fresh Application whose batch verifier is
   BackendSupervisor(CudaBatchVerifier()) at the node's defaults, at
   batch_grace 60 s, holding every result to the archived results and
   every header to the hash chain. Fails unless each lands on the
   publisher's LCL and hash; every checkpoint is in exactly one batch
   holding its replay range's tuples (610 and 64,000 in A1; 610 and
   17,000 in A2), each streaming batch as prevalidate_coalesce fused it
   from the counts the pump saw; the batches' hits equal the signature
   checks of the publisher's apply, with 0 misses, 0 failed batches
   and 0 calls to the native fallback; the verdicts equal the native
   verifier's, false exactly on the flipped transactions; prep msg32
   launches equal ladder launches equal device dispatches equal
   batches, no k launch; the supervisor CLOSED with 0 failures and 0
   skips. It prints each batch's dispatch to landing, the coalesce
   calls, replayed ledgers per second, the collector's passes, A1's
   PipelineStats report, and both kernels timed on the largest
   dispatch's rows (held against their plain versions there first).
15. consensus and flood admission (the first slice of BASELINE.json
   config #5, without the overlay): the four validators of the JAX
   package's topologies.core(4) (one flat quorum set, threshold 3), each
   the port's Application with the port's Config at its defaults and
   the simulation's overrides, on one virtual clock, joined by a
   loopback harness in place of the overlay that hands every node the
   same fixed bursts. Slot 2
   votes maxTxSetSize 1000, slots 3-4 create 2000 accounts, slots 5-9
   carry 1000 one-Payment transactions each in phase 13's mix, which
   every node admits through recv_transactions in bursts of 200 (the
   burst the JAX package's overlay hands its herder most often at 1000
   payments per ledger, counted by tests/node_mix.py); the nodes close
   on their own trigger timers. Before run A, both kernels are held
   against their plain versions on one burst's rows (200 signatures,
   whose last block of 32 holds 8) and timed there. Run A gives each
   node its own VerifyService(BackendSupervisor(CudaBatchVerifier())) at
   phase 7's defaults, run B none (native). Fails unless every node
   externalizes the same values and lands on run B's LCL with equal
   headers, results and metas; bad_sig is true exactly on the flipped
   transactions; every flood verdict equals the oracle; each burst's
   flushes, dispatches and launches are those its size gives; every
   consensus verify is counted by route (device, native bypass, the
   node's service cache) with prep k launches equal to the consensus
   flushes that reach the cutoff; txset validation probes and
   dispatches nothing; the supervisors end CLOSED with 0 failures and 0
   skips and the services with 0 fallbacks. It prints the mix per node
   per ledger, the flushes' walls, each slot's wall from trigger to
   every node closed, the ledger.close.* zones and the collector's
   passes.
16. the node (BASELINE.json config #5, LoadGenerator max-TPS across a
   multi-node topology): the port's simulation/topologies.core(4), four
   Applications on one virtual clock joined by the overlay's
   LoopbackPeerConnections (handshake, MAC, flow control, adverts and
   demands), driven by Simulation.crank_until; node 0's LoadGenerator
   (seed 42) creates 1000 accounts, then submits 1000 payments before
   each of the next 5 ledgers, and every node votes maxTxSetSize 1000
   (tests/node_mix.py --load 1000). Run A: SIGNATURE_VERIFY_BACKEND
   "cuda" on every node's Config, so each Application builds its own
   BackendSupervisor(CudaBatchVerifier()) and VerifyService at the
   node's defaults; run B "native". Then self_check on node 0 of run A.
   Fails unless every node externalizes the same values and lands on
   run B's LCL with equal headers, results and metas; each node's
   recv_transactions bursts, device dispatches, bypassed flushes,
   flushes by reason, consensus verifies and the prevalidator's probes
   are NODE_EXPECTED, the counts predicted on the CPU; every device
   flush equals the oracle; launches equal the device dispatches plus
   self_check's two batches; the supervisors end CLOSED with 0 failures
   and 0 skips and the services with 0 fallbacks; self_check reports
   ok. Both kernels are held against their plain versions on the first
   device flush whose size is not a multiple of 32. It prints the
   ledger walls, the bursts, the device flushes' walls, the overlay's
   counters and self_check's device verifies per second.
17. config #5 across processes (BASELINE.json config #5 in a
   deployment's processes, on one card, nothing sharded): first the command line on
   the card, `python -m stellar_core_tpu_torch --conf node.cfg
   self-check` on a standalone node whose configuration selects the
   "cuda" backend, which must report ok with the device backend. Then
   the port's simulation/cluster.py: Cluster(4, 1), four
   `python -m stellar_core_tpu_torch run` processes (four orgs of one
   validator, the tiered quorum set, each node's own sqlite file and
   bucket directory, real TCP on loopback ports the system hands out,
   the controller's tick off so that no submission is shed, which a
   deployment leaves on), driven
   only through the admin API with the harness's methods, in three
   legs: load (node 0's generateload creates 1000 accounts, then 5 pay
   rounds of 1000, each followed by drain_pending and wait_slot on
   every node); the bad-signature flood (run_cluster_scenario's chaos
   leg: the last node floods, bad_sig_flood_schedule on the honest
   nodes grows 6 forged twins on every body received from it; it
   creates 8 accounts and pays 30); churn (a kill -9 of node 1 while
   node 0 runs one more pay round of 1000, then a restart from its
   data_dir and catchup over the wire). Run A with
   SIGNATURE_VERIFY_BACKEND "cuda" in every node's file, so each node
   process builds its own BackendSupervisor(CudaBatchVerifier()) and
   VerifyService on the card from the kernel library this process
   built; run B "native". Fails unless the headers agree on every node
   after each leg, the restarted node included; every load transaction
   is applied on every node and every applied transaction carries a
   valid signature (no forged twin applied); each honest node's
   bad-signature drops are 6 times the bursts its chaos engine injected
   and some honest node dropped the flooder; in run A every node's
   supervisor is CLOSED with 0 failures, 0 skips and 0 transitions on
   its one device, every node but node 0 (which submits the load) and
   any node whose service flushed 16 or more signatures dispatched to
   the card; every node's metrics show 0 service fallbacks (node 1's
   first life is held to these checks too, on its metrics, perf zones
   and backendstatus read just before the kill, and its dispatches
   count); every node's accounts (read from its sqlite file
   after a graceful stop, exit code 0) are equal, and equal in both runs
   on every account but the flooder's (whose payments apply or age out
   of its queue as its links drop) in balance and transactions sent
   (the seqNum's low 32 bits; its high bits, the ledger the account was
   created in, differ between two native runs too); the build directory
   is unchanged. Both kernels are then held against
   their plain versions and timed on as many rows as the largest device
   dispatch any node reports. It prints the legs' walls, the pay
   rounds, each node's close timers after each leg, its device
   dispatches, their sizes and walls, the service's flushes and the
   backend rows. The node processes' launches are their device
   dispatches (crypto.verify.dispatch.batch in each node's metrics
   route, both of node 1's lives): one prep and one ladder each. The
   metrics count dispatches, not prep modes, so the kernels line gives
   them unsplit: under "cluster" in the ladder's launches by path and
   as "cluster_prep_either_mode" on the two prep rows, which count only
   the launches whose mode was measured.
18. the host tools on the card (BASELINE.json config #3 at
   profile_catchup's size, and the kernels' consensus-safety corpus; one
   card, nothing sharded). The native XDR codec is built (or loaded)
   right after phase 2, so that every phase from 5 on and phase 17's
   node processes run through it; here it must still be live, a hashed
   build in the package's native/build directory, never fallen back to
   the Python path. The port's profile_catchup publisher (64 ledgers of
   30 payments, checkpoint 63) publishes once; three fresh processes
   replay it: R1 with SIGNATURE_VERIFY_BACKEND "cuda" (the Application's
   BackendSupervisor(CudaBatchVerifier()) prevalidates each checkpoint
   on the card) and the codec, under cProfile; R2 the same with
   SC_XDR_NATIVE=0; R3 `python -m stellar_core_tpu_torch.scripts.
   profile_catchup 64 30` as it is (the native backend). Fails unless
   all three land on ledger 63 with the publisher's hash and equal
   bucket-list hashes; R1 and R2 each make the predicted dispatches (one
   of 1,831 signatures), one prep msg32 and one ladder launch each, with
   the native verifier's verdicts, 0 misses and 0 fallback calls, the
   supervisor CLOSED with 0 failures, skips and transitions; R1's
   profile shows the codec's pack, unpack and clone calls and R2's
   none. Both kernels are held against their plain versions on R1's
   dispatch. Then `python -m stellar_core_tpu_torch.scripts.
   cuda_differential orchestrate` (10,000 signatures plus the
   adversarial tail, the card and the CPU's plain versions in their own
   processes) must pass, card == CPU == oracle. Last, the native
   baseline: NativeLib.batch_verify (one thread) and the same call over
   os.cpu_count() threads on phase 5's rows and phase 3's lanes, whose
   verdicts must equal the card's; it prints verifies per second beside
   the host's cores and CPU model (a record, not a claim). It prints each
   replay's rate, R1's top functions by own time, the differential's
   wall and launches.
From phase 13 on, the nodes run with the garbage collector policy the
Application installs (util/gcpolicy.py: the heap frozen, automatic full
passes off), and every eighth node shutdown runs the full pass the
Application's shutdown runs; each phase from 13 on prints the process's
peak resident set size. The oracle verdicts of the live tuples and of phase 5's
tuples are computed in worker processes while phase 2 builds, those of
phases 9 to 12 while their runs go, those of phases 13 and 15 before
their runs, those of phase 16 after its runs. It prints one `kernels`
JSON line (launches by path: verifier, live, sharded, hybrid, txset,
classic, soroban, wasm, close, catchup, consensus, node, cluster (the
ladder's; the prep's cluster launches unsplit, as above), profile
(phase 18's R1 and R2) and differential (its card process); the
msg32 prep and the ladder also carry their times on phase 14's, 15's,
16's, 17's and 18's rows under "catchup", "consensus", "node", "cluster"
and "profile"),
the card line, and last {"ok": true,
"device": {...}}.
"""

import atexit
import collections
import hashlib
import json
import multiprocessing
import os
import queue
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

N = 16384
IN_FLIGHT = 4
ROUNDS = 3
DISTINCT = 512
# integer multiply-adds per SM per clock on compute capability 9.0 (CUDA
# C++ Programming Guide, "Arithmetic Instructions" throughput table, 32-bit
# integer multiply and multiply-add); each 32x32->64 IMAD.WIDE counted once
IMAD_PER_SM_CLK = 64
HBM_BYTES_PER_S = 3.35e12         # H100 SXM data sheet
# 32x32->64 products of one field squaring and one field multiply in ten
# radix-2^25.5 limbs (10 + 45 and 10 x 10)
SQ_PRODUCTS, MUL_PRODUCTS = 55, 100
# the node's defaults for the live verify path (stellar_core_tpu/main/
# config.py:353-380: VERIFY_MAX_BATCH, VERIFY_BATCH_DEADLINE_MS,
# VERIFY_DEVICE_MIN_BATCH, VERIFY_DISPATCH_DEADLINE_MS,
# VERIFY_BREAKER_CANARY_BATCH)
LIVE = dict(max_batch=256, deadline_ms=2.0, device_min_batch=16,
            dispatch_deadline_ms=2000.0, canary_batch=16)
LIVE_N = 16384
TXSET_N = 5000           # the BASELINE.json txset size
TXSET_SEED = 5           # phase 9's ledger, keys and mix
TXSET_MIX = (("multisig", 0.04), ("fee_bump", 0.02), ("flipped", 0.01),
             ("extra_sig", 0.005))   # phase 9's chosen mix
XLM = 10_000_000         # stroops
CLASSIC_N = 5000         # phase 10: the BASELINE.json txset size
CLASSIC_SEED = 6         # phase 10's ledger, keys and mix
# phase 10's chosen mix of the load generator's MIXED_CLASSIC and PRETEND
# modes (stellar_core_tpu/simulation/load_generator.py:210-291); the
# rest, about 40 %, are MIXED_CLASSIC's native payments
CLASSIC_MIX = (("offer", 0.40), ("pretend", 0.15), ("path", 0.02),
               ("create", 0.01), ("change_trust", 0.01), ("flipped", 0.01))
SOROBAN_N = 5000         # phase 11: the BASELINE.json txset size
SOROBAN_SEED = 7         # phase 11's ledger, keys and mix
# phase 11's chosen mix: the load generator's native-SAC transfers
# (stellar_core_tpu/simulation/load_generator.py:335-385) with address
# credentials; the rest, 88 %, are sac_addr
SOROBAN_MIX = (("sac_source", 0.05), ("scvm", 0.03), ("bad_auth", 0.02),
               ("expired", 0.01), ("flipped", 0.01))
SOROBAN_RESOURCE_FEE = 10_000_000   # the load generator's _soroban_ext
WASM_N = 5000            # phase 12: the BASELINE.json txset size
WASM_SEED = 8            # phase 12's ledger, keys and mix
# phase 12's chosen mix of wasm-contract calls; the rest, about 84 %, are
# env_auth (an env-ABI contract's require_auth with address credentials)
WASM_MIX = (("wasm_counter", 0.08), ("sig_ok", 0.03), ("sig_bad", 0.01),
            ("bad_auth", 0.02), ("fuel", 0.01), ("flipped", 0.01))
# the instructions resource of phase 12's fuel kind: one short of what an
# env counter auth_bump with address credentials needs
WASM_FUEL_INSTRUCTIONS = 426_254
CLOSE_ACCOUNTS = 2000    # phase 13: accounts of the load generator's CREATE
CLOSE_TXS = 1000         # phase 13: one-Payment transactions per ledger
CLOSE_LEDGERS = 10       # phase 13: measured ledgers (BASELINE.json config #1)
CLOSE_SEED = 9           # phase 13's permutations, mix and flipped bytes
CLOSE_MIX = (("conflict", 0.02), ("flipped", 0.01))   # the rest: "pair"
CLOSE_MAX_TX_SET = 1000  # the maxTxSetSize the setup votes through a close
# the standalone node's network and the load generator's amounts
# (docs/stellar-core-tpu_standalone.cfg; simulation/load_generator.py
# generate_accounts, generate_payments; main/config.py PEER_PORT)
CLOSE_PASSPHRASE = "Standalone Network ; February 2017"
CLOSE_PEER_PORT = 11625
CLOSE_BALANCE = 10_000_0000000
CLOSE_AMOUNT = 10_000
# the node's staged apply (main/config.py:190,192: APPLY_PARALLEL,
# APPLY_PARALLEL_MIN_TXS)
APPLY_PARALLEL, APPLY_PARALLEL_MIN_TXS = 4, 8
CLOSE_ZONES = ("prepare", "fees", "applyTx", "applyTx.stage", "seal",
               "seal.fsync", "seal.sql")
CLOSE_TABLES = ("accounts", "trustlines", "offers", "accountdata",
                "claimablebalance", "liquiditypool", "contractdata",
                "contractcode", "configsettings", "ttl", "storestate",
                "ledgerheaders", "txhistory", "txfeehistory",
                "txsethistory")
CATCHUP_QUIET = 59       # phase 14: ledgers 5-63 ...
CATCHUP_QUIET_TXS = 10   # ... of 10 one-Payment transactions each
CATCHUP_LEDGERS = 64     # phase 14: ledgers 64-127 of CLOSE_TXS payments
CATCHUP_SEED = 14        # phase 14's permutations, mix and flipped bytes
CATCHUP_TO = 80          # run A2's target ledger
CATCHUP_GRACE_S = 60.0   # batch_grace, as the reference's tests set it
CONSENSUS_NODES = 4      # phase 15: topologies.core(4)'s validators, one
#                          flat quorum set of threshold (2n + 2) // 3
CONSENSUS_LEDGERS = 5    # phase 15: measured ledgers of CLOSE_TXS payments
CONSENSUS_BURST = 200    # phase 15: transactions per recv_transactions call:
#                          the burst the JAX package's overlay hands its
#                          herder most often at 1000 payments per ledger
#                          (tests/node_mix.py --load 1000 --service: 16-17
#                          of each peer's 27 calls; PEER_FLOOD_READING_
#                          CAPACITY caps it)
CONSENSUS_SEED = 15      # phase 15's permutations, mix and flipped bytes
CONSENSUS_TIMEOUT_S = 120.0   # virtual seconds a slot may take
# simulation/topologies.py:41-42: core()'s network and its node seeds
# (:23-25, sha256(b"topo-core-%d" % i))
CORE_PASSPHRASE = "(V) (;,,;) (V)"
CHUNK = 32               # tuples per flush in leg C
FLUSH_REPS = 30          # timed flushes per size for the fixed cost
STAND_IN = 4             # positions of phase 8's stand-in mesh on one card
SICK = 2                 # the sick position of phase 8's window
MESH_CHUNK = 256         # tuples per flush in phase 8's window (max_batch)
HYBRID_N = 5000          # signatures of phase 8's hybrid batch
HYBRID_RANKS = 2
V1_N = 2048              # lanes of the v1 entry in phase 3
SPAWN_TIMEOUT_S = 300
NODE_LOAD = 1000         # phase 16: accounts, then payments per ledger, that
                         # node 0's load generator submits (node_mix --load)
NODE_LEDGERS = 6         # phase 16: ledgers after the first (node_mix's)
NODE_LOAD_SEED = 42      # phase 16: the load generator's seed (node_mix's)
NODE_TIMEOUT_S = 120.0   # virtual seconds a ledger may take (node_mix's)
CLUSTER_ORGS = 4         # phase 17: Cluster(4, 1), four orgs of one validator
CLUSTER_CLOSE_S = 1.0    # phase 17: the nodes' ledger close time (s)
CLUSTER_ROUNDS = 5       # phase 17: leg 1's pay rounds of NODE_LOAD
CLUSTER_FLOOD = (8, 30)  # phase 17: the flooder's accounts and payments
CLUSTER_CHAOS_SEED = 9   # phase 17: run_cluster_scenario's chaos seed
CLUSTER_BURST = 6        # phase 17: bad_sig_flood_schedule's forged twins
                         # per body received from the flooder
CLUSTER_BOOT_S = 120.0   # phase 17: the harness's start_all deadline
# phase 16's counts at NODE_LOAD and NODE_LEDGERS, as tests/node_mix.py
# --load 1000 --backend gives them on the CPU in both packages (a
# counting host verifier in place of the card's; tests/test_torch_node_mix.py
# holds the two packages and this table equal): per node (node 0 runs
# the load generator) every recv_transactions call's frames in order,
# the verifier's dispatches (device by prep mode, bypassed, their
# sizes), the service's flushes by reason and fallbacks, the consensus
# verifies; the txset prevalidator's probes; every node's LCL
NODE_EXPECTED = {'recv_transactions_calls': [[],
                                             [178, 200, 122, 176, 200, 200,
                                              200, 200, 24, 191, 199, 200,
                                              200, 200, 10, 169, 200, 200,
                                              200, 200, 31, 187, 200, 200,
                                              200, 200, 13],
                                             [178, 200, 122, 176, 200, 200,
                                              200, 200, 24, 191, 200, 200,
                                              200, 200, 9, 170, 200, 200, 200,
                                              200, 30, 188, 200, 200, 200,
                                              200, 12],
                                             [178, 200, 122, 176, 200, 200,
                                              200, 200, 24, 190, 200, 200,
                                              200, 200, 10, 168, 200, 200,
                                              200, 200, 32, 186, 200, 200,
                                              200, 200, 14]],
                 'verifier': [{'device': {'msg32': 0, 'k': 0},
                               'bypass': 134,
                               'device_sizes': [],
                               'bypass_sizes': [[1, 134]],
                               'flush_reasons': {'demand': 134},
                               'fallbacks': 0,
                               'consensus_calls': {'envelope': 126,
                                                   'value': 26}},
                              {'device': {'msg32': 25, 'k': 0},
                               'bypass': 136,
                               'device_sizes': [[24, 1], [31, 1], [122, 1],
                                                [169, 1], [176, 1], [178, 1],
                                                [187, 1], [191, 1], [199, 1],
                                                [200, 16]],
                               'bypass_sizes': [[1, 134], [10, 1], [13, 1]],
                               'flush_reasons': {'demand': 161},
                               'fallbacks': 0,
                               'consensus_calls': {'envelope': 127,
                                                   'value': 20}},
                              {'device': {'msg32': 25, 'k': 0},
                               'bypass': 135,
                               'device_sizes': [[24, 1], [30, 1], [122, 1],
                                                [170, 1], [176, 1], [178, 1],
                                                [188, 1], [191, 1],
                                                [200, 17]],
                               'bypass_sizes': [[1, 133], [9, 1], [12, 1]],
                               'flush_reasons': {'demand': 160},
                               'fallbacks': 0,
                               'consensus_calls': {'envelope': 126,
                                                   'value': 19}},
                              {'device': {'msg32': 25, 'k': 0},
                               'bypass': 136,
                               'device_sizes': [[24, 1], [32, 1], [122, 1],
                                                [168, 1], [176, 1], [178, 1],
                                                [186, 1], [190, 1],
                                                [200, 17]],
                               'bypass_sizes': [[1, 134], [10, 1], [14, 1]],
                               'flush_reasons': {'demand': 161},
                               'fallbacks': 0,
                               'consensus_calls': {'envelope': 127,
                                                   'value': 20}}],
                 'prevalidator_probes': {'hits': 1506, 'misses': 0},
                 'lcl': ['42f2f30b0af9544fccac2325bb213eca'
                         '71afcbfc5247c26ce1284d612b1ef5a9']}


def smi(query):
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def wnaf(v, w=5):
    """(nonzero digits, index of the top digit) of v's width-w NAF."""
    n, top, i = 0, -1, 0
    while v:
        if v & 1:
            d = v & ((1 << w) - 1)
            v -= d - (1 << w) if d >> (w - 1) else d
            n, top = n + 1, i
        v >>= 1
        i += 1
    return n, top


def ladder_products(s_rows, k_rows):
    """Products that [S]B + [k](-A) in canonical affine form needs on
    these scalars at the fewest point operations of libsodium's
    ge25519_double_scalarmult_vartime: width-5 NAF digits of S and k;
    below the top digit, per position a doubling (4 squarings) and a
    p1p1 -> p2 conversion (3 multiplies), per nonzero digit of k a p3
    conversion and cached addition of an odd multiple of -A (4 + 4), of
    S a p3 conversion and mixed addition of a stored multiple of B
    (4 + 3); the table of -A, 3(-A), ..., 15(-A) (4 squarings, 69
    multiplies); Z^-1 (254 squarings, 11 multiplies); x and y (2)."""
    total = 0
    memo = {}
    for key in zip(s_rows, k_rows):
        if key not in memo:
            nb, tb = wnaf(int.from_bytes(key[0], "little"))
            na, ta = wnaf(int.from_bytes(key[1], "little"))
            top = max(ta, tb, 0)
            # the top digit's table entry is loaded, not added
            first = 8 if ta == top else 7 if tb == top else 0
            sq = 4 + 4 * top + 254
            mul = 69 + 3 * top + 8 * na + 7 * nb - first + 11 + 2
            memo[key] = sq * SQ_PRODUCTS + mul * MUL_PRODUCTS
        total += memo[key]
    return total


def sass_mix(lib_path, nvcc):
    """Static SASS opcode counts per function of the built library, from
    cuobjdump beside nvcc: {function: Counter(opcode)}, or None when the
    toolkit has no cuobjdump."""
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    if not os.path.exists(tool):
        return None
    out = subprocess.run([tool, "-sass", lib_path], check=True,
                         capture_output=True, text=True).stdout
    mix, fn = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = m.group(1)
            mix[fn] = collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)", line)
        if m and fn:
            mix[fn][m.group(1)] += 1
    return mix


def geometry(info, n, sms):
    """Launch geometry of a kernel at n signatures: resident warps per SM
    (the occupancy limit) and the warps per SM that n fills."""
    threads = n * info["threads_per_sig"]
    warps = -(-threads // 32)
    resident = info["blocks_per_sm"] * info["block"] // 32
    return dict(info, warps_per_sm_resident=resident,
                warps_per_sm=min(resident, warps / sms))


def strict_flags(ref, torsion_y, pub, sig):
    """The prep kernel's ok from the oracle's primitives: S < L; A and R
    canonical and not of a torsion y; A decompresses strictly."""
    mask = (1 << 255) - 1
    ya = int.from_bytes(pub, "little") & mask
    yr = int.from_bytes(sig[:32], "little") & mask
    return (int.from_bytes(sig[32:], "little") < ref.L
            and ya < ref.P and yr < ref.P
            and ya not in torsion_y and yr not in torsion_y
            and ref.pt_decompress(pub, strict=True) is not None)


def rows(tuples):
    """(pubs (n,32), sigs (n,64), msgs) as numpy uint8 arrays and a list."""
    n = len(tuples)
    pubs = np.frombuffer(b"".join(p for p, _, _ in tuples),
                         np.uint8).reshape(n, 32)
    sigs = np.frombuffer(b"".join(s for _, s, _ in tuples),
                         np.uint8).reshape(n, 64)
    return pubs, sigs, [m for _, _, m in tuples]


def describe(info):
    return (f"{info['threads_per_sig']} thread(s) per signature, blocks of "
            f"{info['block']}, {info['warps_per_sm']:.2f} warps per SM at "
            f"n={N} (resident limit {info['warps_per_sm_resident']}), "
            f"{info['regs']} registers, {info['local_bytes']} B local")


def median_ms(fn, reps=25, warm=3):
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def once_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def device_ms_by_name(prof):
    """Device time in ms by event name from a torch.profiler run."""
    by_name = {}
    for ev in prof.key_averages():
        # device-side events only (kernels, copies): a CPU op's device
        # time repeats that of the kernels it launched
        if not str(ev.device_type).endswith("CUDA"):
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us:
            by_name[ev.key] = by_name.get(ev.key, 0.0) + us / 1e3
    return by_name


def max_abs_err(xs, ys):
    return max(int((x.to(torch.int16) - y.to(torch.int16)).abs().max())
               for x, y in zip(xs, ys))


def live_tuples(SecretKey, n):
    """n distinct tuples for leg A: tuple i signs a 100-500 byte message
    when i % 10 == 5 (the SCP-envelope shape, host-k path) and a 32-byte
    tx hash otherwise; one bit of the signature is flipped when
    i % 10 == 0. The share of long messages is chosen so that both prep
    modes run; it is not a measured traffic mix."""
    rng = np.random.default_rng(11)
    keys = [SecretKey.pseudo_random_for_testing(20000 + i)
            for i in range(64)]
    out = []
    for i in range(n):
        sk = keys[i % len(keys)]
        if i % 10 == 5:
            msg = rng.bytes(int(rng.integers(100, 501)))
        else:
            msg = hashlib.sha256(b"tx-%d" % i).digest()
        sig = sk.sign(msg)
        if i % 10 == 0:
            j, bit = int(rng.integers(64)), int(rng.integers(8))
            sig = sig[:j] + bytes([sig[j] ^ (1 << bit)]) + sig[j + 1:]
        out.append((sk.public_key().raw, sig, msg))
    return out


def live_phase(card, items, want):
    """Phase 7: the live verify path on the card (see the docstring)."""
    from stellar_core_tpu_torch.crypto.keys import (clear_verify_cache,
                                                    host_verifier)
    from stellar_core_tpu_torch.native import loader
    from stellar_core_tpu_torch.ops import ed25519_kernel as EK
    from stellar_core_tpu_torch.ops import ladder as LD
    from stellar_core_tpu_torch.ops.backend_supervisor import (
        CLOSED, OPEN, BackendSupervisor)
    from stellar_core_tpu_torch.ops.verifier import CudaBatchVerifier
    from stellar_core_tpu_torch.ops.verify_service import VerifyService
    from stellar_core_tpu_torch.util import chaos
    from stellar_core_tpu_torch.util.metrics import MetricsRegistry
    from stellar_core_tpu_torch.util.perf import ZoneRegistry
    from stellar_core_tpu_torch.util.timer import ClockMode, VirtualClock

    host = host_verifier()
    where = os.path.relpath(loader.get_lib().path) if host == "native" \
        else "oracle"
    print(f"live: host verifier for the bypass and the fallback: {host} "
          f"({where})", flush=True)
    if host != "native":
        raise SystemExit("live: the native host library did not load")

    def stack(clock, **over):
        kw = dict(LIVE, **over)
        reg, perf = MetricsRegistry(), ZoneRegistry()
        v = CudaBatchVerifier(perf=perf, metrics=reg,
                              device_min_batch=kw["device_min_batch"])
        sup = BackendSupervisor(
            v, clock=clock, metrics=reg, perf=perf,
            dispatch_deadline_ms=kw["dispatch_deadline_ms"],
            canary_batch=kw["canary_batch"])
        svc = VerifyService(sup, clock=clock, metrics=reg, perf=perf,
                            max_batch=kw["max_batch"],
                            deadline_ms=kw["deadline_ms"])
        return reg, perf, v, sup, svc

    def counts():
        return (EK.prep.launches, LD.ladder.launches)

    def healthy(tag, reg, perf, sup, svc, got, want_):
        """The supervisor must not hide the device: no failure, no
        fallback, CLOSED throughout, launches == device dispatches."""
        m = reg.to_json()
        st = sup.status()
        device = m["crypto.verify.dispatch.batch"]["count"]
        native = perf.report().get("crypto.batchVerify.native",
                                   {"count": 0})["count"]
        problems = []
        mism = sum(g != w for g, w in zip(got, want_))
        if mism or len(got) != len(want_):
            problems.append(f"{mism} verdicts differ from the oracle")
        if any(st["failures"].values()):
            problems.append(f"supervisor failures {st['failures']}")
        if m["crypto.verify_service.fallback"]["count"]:
            problems.append("service fallbacks")
        if st["transitions"] or st["state"] != CLOSED:
            problems.append(f"breaker moved: {st['transitions']}")
        if counts() != (device, device) or not device:
            problems.append(f"launches {counts()} != device dispatches "
                            f"{device}")
        if st["dispatches"] != device + native:
            problems.append(f"supervisor dispatches {st['dispatches']} != "
                            f"{device} device + {native} bypassed")
        if problems:
            raise SystemExit(f"live leg {tag}: " + "; ".join(problems))
        return st, device, native

    def describe_leg(tag, reg, svc, st, device, native):
        stats = svc.stats()
        occ = reg.to_json()["crypto.verify_service.occupancy"]
        wall = reg.to_json()["crypto.verify.dispatch.wall"]
        q = {k: occ[k] for k in ("count", "min", "median", "75%", "99%",
                                 "max", "mean")}
        print(f"  leg {tag}: flushes by reason {stats['flush_reasons']}; "
              f"occupancy {q}; queue-wait p50 "
              f"{stats['queue_wait_p50_ms']} ms, p99 "
              f"{stats['queue_wait_p99_ms']} ms; dispatch->first collect "
              f"(crypto.verify.dispatch.wall: when the caller awaits, not "
              f"when the verdict is ready) median "
              f"{wall['median'] * 1e3:.3f} ms, p99 "
              f"{wall['99%'] * 1e3:.3f} ms; supervisor dispatches "
              f"{st['dispatches']} = {device} on the card + {native} "
              f"bypassed; launches prep {EK.prep.launches} (msg32 "
              f"{EK.prep.mode_launches[0]}, k {EK.prep.mode_launches[1]}), "
              f"ladder {LD.ladder.launches}; failures {st['failures']}; "
              f"fallbacks {stats['fallbacks']}; breaker {st['state']}",
              flush=True)

    launches = {"msg32": 0, "k": 0, "ladder": 0}

    def tally():
        launches["msg32"] += EK.prep.mode_launches[0]
        launches["k"] += EK.prep.mode_launches[1]
        launches["ladder"] += LD.ladder.launches

    # --- leg A: flood admission ---------------------------------------
    clock = VirtualClock(ClockMode.REAL_TIME)

    def flood(svc):
        clear_verify_cache()
        t0 = time.perf_counter()
        futs = []
        for p, s, m in items:
            futs.append(svc.submit(p, s, m))
            clock.crank(False)
        svc.drain()
        return time.perf_counter() - t0, [f.result() for f in futs]

    reg, perf, v, sup, svc = stack(clock)
    zero_launches()
    wall_a, got = flood(svc)
    st, device, native = healthy("A", reg, perf, sup, svc, got, want)
    print(f"live leg A (mechanism smoke, chosen mix): {len(items)} single "
          f"submits then drain in "
          f"{wall_a * 1e3:.1f} ms = {len(items) / wall_a:.1f} verifies/s, "
          f"{sum(got)} verify, 0 differ from the oracle [{card}]",
          flush=True)
    describe_leg("A", reg, svc, st, device, native)
    tally()
    sup.shutdown()
    # the same leg once more on a fresh stack under torch.profiler
    # (device activity only): where the leg's time goes on the card
    from torch.profiler import ProfilerActivity, profile
    reg_p, perf_p, v_p, sup_p, svc_p = stack(clock)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall_p, got_p = flood(svc_p)
    sup_p.shutdown()
    if got_p != want:
        raise SystemExit("live leg A under the profiler: verdicts differ")
    busy = device_ms_by_name(prof)
    busy_ms = sum(busy.values())
    if busy_ms:
        top = sorted(busy.items(), key=lambda kv: -kv[1])[:4]
        print(f"  leg A profiled (device activity only): wall "
              f"{wall_p * 1e3:.1f} ms, device busy {busy_ms:.3f} ms, idle "
              f"share {1 - busy_ms / (wall_p * 1e3):.4f}; "
              + "; ".join(f"{k[:40]} {ms_:.3f} ms" for k, ms_ in top)
              + f" [{card}]", flush=True)
    else:
        print("  leg A profiled: the profiler saw no device time (not "
              "measured)", flush=True)

    # --- leg B: a txset of 5000 tx-hash signatures ----------------------
    txset = [i for i, t in enumerate(items) if len(t[2]) == 32][:TXSET_N]
    b_items, b_want = [items[i] for i in txset], [want[i] for i in txset]
    reg, perf, v, sup, svc = stack(clock)
    clear_verify_cache()
    zero_launches()
    t0 = time.perf_counter()
    got = [f.result() for f in svc.submit_many(b_items)]
    wall_b = time.perf_counter() - t0
    st, device, native = healthy("B", reg, perf, sup, svc, got, b_want)
    print(f"live leg B: txset of {len(b_items)} through submit_many, first "
          f"submit to last result {wall_b * 1e3:.2f} ms, {sum(got)} verify, "
          f"0 differ from the oracle [{card}]", flush=True)
    describe_leg("B", reg, svc, st, device, native)
    tally()

    # --- the fixed cost of a small flush (sync, through the verifier) ---
    m32 = b_items[:256]
    for n in (16, 256):
        rows_ = m32[:n]
        v.verify_tuples(rows_)                         # warm
        walls = []
        for _ in range(FLUSH_REPS):
            t0 = time.perf_counter()
            v.verify_tuples(rows_)
            walls.append((time.perf_counter() - t0) * 1e3)
        host = np.zeros((4, n, 32), dtype=np.uint8)
        pins = []
        for _ in range(FLUSH_REPS):
            t0 = time.perf_counter()
            torch.from_numpy(host).pin_memory()
            torch.empty(n, dtype=torch.bool, pin_memory=True)
            pins.append((time.perf_counter() - t0) * 1e3)
        print(f"live flush cost at n={n} (msg32, verify_tuples, "
              f"{FLUSH_REPS} runs): "
              f"wall median {statistics.median(walls):.3f} ms, min "
              f"{min(walls):.3f} ms; of which pin_memory() of the inputs "
              f"and the pinned result allocation median "
              f"{statistics.median(pins):.3f} ms [{card}]", flush=True)
    sup.shutdown()

    # --- leg C: chaos on the card under a virtual clock -----------------
    base = max(txset) + 1
    chunks = [(items[base + CHUNK * i: base + CHUNK * (i + 1)],
               want[base + CHUNK * i: base + CHUNK * (i + 1)])
              for i in range(9)]
    vclock = VirtualClock(ClockMode.VIRTUAL_TIME)
    reg, perf, v, sup, svc = stack(vclock)
    zero_launches()

    def through(service, k):
        got = [f.result() for f in service.submit_many(chunks[k][0])]
        if got != chunks[k][1]:
            raise SystemExit(f"live leg C chunk {k}: verdicts differ from "
                             "the oracle")

    def fail(msg):
        raise SystemExit(f"live leg C: {msg}")

    t_c = time.perf_counter()
    chaos.install(chaos.ChaosEngine(31, [chaos.FaultSpec(
        "ops.backend.dispatch", "io_error", start=0, count=3)]))
    try:
        for k in range(3):
            through(svc, k)
        st = sup.status()
        if sup.state != OPEN or st["failures"]["transient"] != 3 \
                or counts() != (0, 0):
            fail(f"3 io_errors: state {sup.state}, {st['failures']}, "
                 f"launches {counts()}")
        print(f"live leg C1: 3 io_error at ops.backend.dispatch -> breaker "
              f"{sup.state}, failures {st['failures']}, launches "
              f"{counts()}", flush=True)
        d_open = st["devices"][0]["dispatches"]
        for k in (3, 4):
            through(svc, k)
        st = sup.status()
        if st["devices"][0]["dispatches"] != d_open or counts() != (0, 0) \
                or st["skips"] != 2:
            fail(f"dispatch while OPEN: {st['devices'][0]}, launches "
                 f"{counts()}")
        print(f"live leg C2: 2 flushes while OPEN resolved natively, device "
              f"dispatches {d_open} -> {st['devices'][0]['dispatches']}, "
              f"skips {st['skips']}, launches {counts()}", flush=True)
        eta = st["next_probe_in_s"]
        vclock.crank(True)                   # past the backoff: the probe
        st = sup.status()
        moves = [(t["from"], t["to"], t["reason"], t["device_dispatches"])
                 for t in st["transitions"]]
        if sup.state != CLOSED or counts() != (1, 1) \
                or [m[:3] for m in moves] != [
                    (CLOSED, OPEN, "failure_threshold"),
                    (OPEN, "HALF_OPEN", "probe_timer"),
                    ("HALF_OPEN", CLOSED, "probe_ok")] \
                or moves[0][3] != moves[1][3]:
            fail(f"canary: state {sup.state}, launches {counts()}, {moves}")
        print(f"live leg C3: virtual clock +{vclock.now():.3f} s (probe "
              f"due in {eta} s) -> canary of {LIVE['canary_batch']} on the "
              f"card (launches {counts()}) -> {sup.state}; transitions "
              f"{moves}", flush=True)
        through(svc, 5)
        if counts() != (2, 2):
            fail(f"traffic after the close did not reach the card: "
                 f"{counts()}")
    finally:
        chaos.uninstall()

    reg2, perf2, v2, sup2, svc2 = stack(vclock, dispatch_deadline_ms=200.0)
    chaos.install(chaos.ChaosEngine(32, [chaos.FaultSpec(
        "ops.backend.dispatch", "hang", start=0, count=1)]))
    try:
        t0 = time.perf_counter()
        through(svc2, 6)
        hang_ms = (time.perf_counter() - t0) * 1e3
        st2 = sup2.status()
        if st2["failures"]["timeout"] != 1 or \
                [q["batch"] for q in st2["quarantined"]] != [CHUNK]:
            fail(f"hang: {st2['failures']}, {st2['quarantined']}")
        print(f"live leg C4: hang at ops.backend.dispatch, 200 ms deadline -> "
              f"resolved natively in {hang_ms:.1f} ms, failures "
              f"{st2['failures']}, quarantined {st2['quarantined']}",
              flush=True)
    finally:
        chaos.uninstall()
        sup2.shutdown()

    bare_reg = MetricsRegistry()
    bare = VerifyService(CudaBatchVerifier(device_min_batch=16),
                         clock=vclock, metrics=bare_reg)
    chaos.install(chaos.ChaosEngine(33, [chaos.FaultSpec(
        "ops.verifier.batch", "io_error", start=0, count=2)]))
    try:
        before = sup.status()["failures"]["transient"]
        through(svc, 7)
        st = sup.status()
        if st["failures"]["transient"] != before + 1 or \
                svc.stats()["fallbacks"] or sup.state != CLOSED:
            fail(f"io_error at ops.verifier.batch under the supervisor: "
                 f"{st['failures']}, fallbacks {svc.stats()['fallbacks']}")
        through(bare, 8)
        if bare.stats()["fallbacks"] != 1:
            fail("io_error at ops.verifier.batch: the bare service did "
                 "not fall back")
        print(f"live leg C5: io_error at ops.verifier.batch -> the "
              f"supervisor records it (transient {st['failures']['transient']}"
              f", breaker {sup.state}, service fallbacks "
              f"{svc.stats()['fallbacks']}); a bare VerifyService("
              f"CudaBatchVerifier) falls back ({bare.stats()['fallbacks']})",
              flush=True)
    finally:
        chaos.uninstall()
        sup.shutdown()
    print(f"live leg C: {9 * CHUNK} tuples, 0 verdicts off the oracle, "
          f"{(time.perf_counter() - t_c) * 1e3:.1f} ms [{card}]", flush=True)
    return launches, {"verifies_per_s_A": len(items) / wall_a,
                      "txset_ms_B": wall_b * 1e3}


def launch_counts():
    from stellar_core_tpu_torch.ops import ed25519_kernel as EK
    from stellar_core_tpu_torch.ops import ladder as LD
    return {"msg32": EK.prep.mode_launches[0], "k": EK.prep.mode_launches[1],
            "ladder": LD.ladder.launches}


def zero_launches():
    from stellar_core_tpu_torch.ops import ed25519_kernel as EK
    from stellar_core_tpu_torch.ops import ladder as LD
    EK.prep.launches = LD.ladder.launches = 0
    EK.prep.mode_launches[:] = [0, 0]


def check_launches(tag, want):
    """Launches since the last zero_launches(): prep (by mode) and ladder
    each equal to the shards dispatched, `want` = {"msg32": m, "k": k}."""
    got = launch_counts()
    want = dict(want, ladder=want.get("msg32", 0) + want.get("k", 0))
    want = {m: want.get(m, 0) for m in ("msg32", "k", "ladder")}
    if got != want:
        raise SystemExit(f"mesh {tag}: launches {got} != active shards "
                         f"{want}")
    return got


def hybrid_rank(rank, world, init_file, root, device, items, want, out):
    """One rank of phase 8's two-process hybrid leg (a spawned process):
    the hybrid verifier over a (world, 2) grid on `device`, every rank
    handed the same batch; then that batch and its reverse in flight,
    collected in opposite orders on the two ranks (the gathers follow
    dispatch order). Reports its verdicts' agreement with the oracle,
    its launches and the bytes it broadcast."""
    sys.path.insert(0, root)
    import torch.distributed as dist
    from stellar_core_tpu_torch.ops.multihost import (HybridShardedVerifier,
                                                      make_hybrid_mesh)
    dist.init_process_group("gloo", init_method="file://" + init_file,
                            world_size=world, rank=rank)
    try:
        sent = []
        broadcast = dist.broadcast

        def watched(tensor, src, *a, **k):
            if src == rank:
                sent.append(tensor.numel() * tensor.element_size())
            return broadcast(tensor, src, *a, **k)
        dist.broadcast = watched
        v = HybridShardedVerifier(make_hybrid_mesh(
            [torch.device(device)] * 2 * world))
        zero_launches()
        t0 = time.perf_counter()
        got = v.verify_tuples(items)
        ms = (time.perf_counter() - t0) * 1e3
        mism = sum(g != w for g, w in zip(got, want))
        handles = [v.verify_tuples_async(items),
                   v.verify_tuples_async(items[::-1])]
        pair = [want, want[::-1]]
        for i in ((0, 1) if rank % 2 == 0 else (1, 0)):
            mism += sum(g != w for g, w in zip(handles[i](), pair[i]))
        out.put({"rank": rank, "mism": mism, "n": len(got),
                 "launches": launch_counts(), "sent": sent,
                 "shape": list(v.mesh.devices.shape), "ms": ms})
    finally:
        dist.destroy_process_group()


def mesh_phase(card, dev, v, main_rows, main_want, batch, batch_want,
               batch_got, items, want):
    """Phase 8: the multi-device verify path (see the docstring). Returns
    the launches of its sharded and hybrid legs."""
    from stellar_core_tpu_torch.ops.backend_supervisor import (
        CLOSED, HALF_OPEN, OPEN, BackendSupervisor)
    from stellar_core_tpu_torch.ops.multihost import (TAG_BYTES,
                                                      HybridShardedVerifier,
                                                      make_hybrid_mesh)
    from stellar_core_tpu_torch.ops.shard_math import shard_shares
    from stellar_core_tpu_torch.ops.verifier import ShardedBatchVerifier
    from stellar_core_tpu_torch.ops.verify_service import VerifyService
    from stellar_core_tpu_torch.util import chaos
    from stellar_core_tpu_torch.util.metrics import MetricsRegistry
    from stellar_core_tpu_torch.util.perf import ZoneRegistry
    from stellar_core_tpu_torch.util.timer import ClockMode, VirtualClock

    pubs, sigs, msgs = main_rows
    paths = {"sharded": collections.Counter(),
             "hybrid": collections.Counter()}

    def exact(tag, got, want_):
        mism = sum(bool(g) != w for g, w in zip(got, want_))
        if mism or len(got) != len(want_):
            raise SystemExit(f"mesh {tag}: {mism} verdicts differ from the "
                             f"oracle ({len(got)} of {len(want_)})")

    def in_flight(verifier):
        handles = [verifier.verify_batch_async(pubs, sigs, msgs)
                   for _ in range(IN_FLIGHT)]
        return [h().tolist() for h in handles]

    # --- 8.1 the node's choice: every visible card -----------------------
    node = ShardedBatchVerifier()
    zero_launches()
    t0 = time.perf_counter()
    for res in in_flight(node):
        exact("8.1", res, main_want)
    dt = time.perf_counter() - t0
    shards = IN_FLIGHT * min(node.ndev, N)
    paths["sharded"].update(check_launches("8.1", {"msg32": shards}))
    print(f"mesh 8.1: ShardedBatchVerifier() over {node.ndev} visible "
          f"card(s) ({'single-survivor path' if node.ndev == 1 else 'mesh'}"
          f"): {IN_FLIGHT} x {N} msg32 in flight in {dt * 1e3:.2f} ms, 0 "
          f"verdicts off the oracle, {shards} launches of each kernel = "
          f"active shards x dispatches [{card}]", flush=True)

    # --- 8.2 a stand-in mesh: four positions on one card -----------------
    reg = MetricsRegistry()
    mesh = ShardedBatchVerifier([dev] * STAND_IN, metrics=reg)
    zero_launches()
    for res in in_flight(mesh):
        exact("8.2 in flight", res, main_want)
    paths["sharded"].update(check_launches(
        "8.2 in flight", {"msg32": IN_FLIGHT * STAND_IN}))
    zero_launches()
    got = mesh.verify_tuples(batch)
    exact("8.2 host-k", got, batch_want)
    if got != batch_got:
        raise SystemExit("mesh 8.2: host-k verdicts differ from "
                         "CudaBatchVerifier's")
    paths["sharded"].update(check_launches("8.2 host-k", {"k": STAND_IN}))
    walls = []
    for active in ((0, 2, 3), (1,), tuple(range(STAND_IN))):
        mesh.set_active_devices(active)
        zero_launches()
        got, ms = once_ms(lambda: mesh.verify_tuples(batch))
        exact(f"8.2 active {active}", got, batch_want)
        paths["sharded"].update(check_launches(f"8.2 active {active}",
                                               {"k": len(active)}))
        walls.append((active, ms))
        if active == (1,):
            # a probe pinned to a position outside the active set
            before = reg.to_json()[
                "crypto.verify.dispatch.device3.batch"]["count"]
            zero_launches()
            got = mesh.verify_tuples_async_on(3, batch[:256])()
            exact("8.2 pinned probe", got, batch_want[:256])
            paths["sharded"].update(check_launches("8.2 pinned probe",
                                                   {"k": 1}))
            after = reg.to_json()[
                "crypto.verify.dispatch.device3.batch"]["count"]
            if after != before + 1 or mesh.active_indices() != (1,):
                raise SystemExit("mesh 8.2: the pinned probe did not run on "
                                 "position 3 alone")
    _, single_k = once_ms(lambda: v.verify_tuples(batch))
    single, single_m = once_ms(lambda: v.verify_batch(pubs, sigs, msgs))
    stand_in, mesh_m = once_ms(lambda: mesh.verify_batch(pubs, sigs, msgs))
    if single.tolist() != stand_in.tolist():
        raise SystemExit("mesh 8.2: msg32 verdicts differ from "
                         "CudaBatchVerifier's")
    print(f"mesh 8.2 (a stand-in: {STAND_IN} positions on one card share its "
          f"stream, so shards run one after another; not multi-card "
          f"scaling): {IN_FLIGHT} x {N} msg32 in flight and the {len(batch)} "
          f"host-k batch exact and equal to CudaBatchVerifier's; shrink/"
          f"regrow exact; pinned probe to inactive position 3 exact; "
          f"dispatch walls at n={len(batch)} host-k: "
          + ", ".join(f"active {a} {ms:.2f} ms" for a, ms in walls)
          + f", CudaBatchVerifier {single_k:.2f} ms; at n={N} msg32: stand-in "
          f"{mesh_m:.2f} ms, CudaBatchVerifier {single_m:.2f} ms [{card}]",
          flush=True)

    # --- 8.3 the sick-device window on the card --------------------------
    m32 = [i for i, t in enumerate(items) if len(t[2]) == 32]
    chunks = [([items[i] for i in m32[MESH_CHUNK * c:MESH_CHUNK * (c + 1)]],
               [want[i] for i in m32[MESH_CHUNK * c:MESH_CHUNK * (c + 1)]])
              for c in range(6)]
    vclock = VirtualClock(ClockMode.VIRTUAL_TIME)
    reg, perf = MetricsRegistry(), ZoneRegistry()
    sick_mesh = ShardedBatchVerifier(
        [dev] * STAND_IN, perf=perf, metrics=reg,
        device_min_batch=LIVE["device_min_batch"])
    sup = BackendSupervisor(
        sick_mesh, clock=vclock, metrics=reg, perf=perf,
        failure_threshold=2, jitter_seed=11,
        dispatch_deadline_ms=LIVE["dispatch_deadline_ms"],
        canary_batch=LIVE["canary_batch"])
    svc = VerifyService(sup, clock=vclock, metrics=reg, perf=perf,
                        max_batch=LIVE["max_batch"],
                        deadline_ms=LIVE["deadline_ms"])

    def batches():
        m = reg.to_json()
        return [m["crypto.verify.dispatch.device%d.batch" % i]["count"]
                for i in range(STAND_IN)]

    def through(k):
        got = [f.result() for f in svc.submit_many(chunks[k][0])]
        exact(f"8.3 flush {k}", got, chunks[k][1])

    def fail(msg):
        raise SystemExit(f"mesh 8.3: {msg}")

    chaos.install(chaos.ChaosEngine(11, [chaos.FaultSpec(
        "ops.backend.dispatch.device", "io_error", start=0, count=3,
        match={"device": SICK})]))
    try:
        zero_launches()
        for k in (0, 1):
            through(k)
        st = sup.status()
        states = [d["state"] for d in st["devices"]]
        if states != [CLOSED, CLOSED, OPEN, CLOSED] or sup.state != CLOSED \
                or sick_mesh.active_indices() != (0, 1, 3) \
                or launch_counts()["ladder"]:
            fail(f"after 2 faults: {states}, aggregate {sup.state}, active "
                 f"{sick_mesh.active_indices()}, launches {launch_counts()}")
        frozen = batches()
        for k in (2, 3, 4):
            through(k)
        served = batches()
        open_launches = check_launches("8.3 while OPEN",
                                       {"msg32": 3 * (STAND_IN - 1)})
        if served[SICK] != frozen[SICK] or any(
                served[i] != frozen[i] + 3 for i in range(STAND_IN)
                if i != SICK):
            fail(f"while OPEN: per-position batches {frozen} -> {served}")
        paths["sharded"].update(open_launches)
        print(f"mesh 8.3: io_error x2 at ops.backend.dispatch.device "
              f"(device {SICK}) -> position {SICK} OPEN, siblings CLOSED, "
              f"aggregate {sup.state}, active {sick_mesh.active_indices()}; "
              f"3 flushes of {MESH_CHUNK} while OPEN: per-position batches "
              f"{frozen} -> {served}, launches {open_launches} (none on "
              f"position {SICK})", flush=True)
        zero_launches()
        for _ in range(8):                     # the probe timers
            if sup.status()["devices"][SICK]["state"] == CLOSED:
                break
            vclock.crank(True)
        st = sup.status()
        moves = [(t["from"], t["to"], t["reason"]) for t in st["transitions"]
                 if t["device"] == SICK]
        if moves != [(CLOSED, OPEN, "failure_threshold"),
                     (OPEN, HALF_OPEN, "probe_timer"),
                     (HALF_OPEN, OPEN, "probe_transient"),
                     (OPEN, HALF_OPEN, "probe_timer"),
                     (HALF_OPEN, CLOSED, "probe_ok")] \
                or sick_mesh.active_indices() != tuple(range(STAND_IN)) \
                or batches()[SICK] != served[SICK] + 1:
            fail(f"probes: {moves}, active {sick_mesh.active_indices()}, "
                 f"batches {batches()}")
        paths["sharded"].update(check_launches("8.3 probes", {"msg32": 1}))
        zero_launches()
        through(5)
        paths["sharded"].update(check_launches("8.3 regrown",
                                               {"msg32": STAND_IN}))
        if [d["state"] for d in sup.status()["devices"]] != \
                [CLOSED] * STAND_IN or any(sup.status()["failures"][c]
                                           for c in ("fatal", "timeout")):
            fail(f"after the window: {sup.status()}")
        print(f"mesh 8.3: virtual clock +{vclock.now():.3f} s: the first "
              f"probe failed at the seam, the second ran the canary on "
              f"position {SICK} alone and closed it; transitions {moves}; "
              f"regrown {sick_mesh.active_indices()}; 6 x {MESH_CHUNK} "
              f"verdicts exact; failures {sup.status()['failures']} [{card}]",
              flush=True)
    finally:
        chaos.uninstall()
        sup.shutdown()

    # --- 8.4 hybrid: a (2, 2) grid in one process, then two gloo ranks ----
    hb_items = [items[i] for i in m32[:HYBRID_N]]
    hb_want = [want[i] for i in m32[:HYBRID_N]]
    hyb = HybridShardedVerifier(make_hybrid_mesh([dev] * 4, n_hosts=2))
    zero_launches()
    got, ms = once_ms(lambda: hyb.verify_tuples(hb_items))
    exact("8.4 one process", got, hb_want)
    paths["hybrid"].update(check_launches("8.4 one process", {"msg32": 4}))
    print(f"mesh 8.4: HybridShardedVerifier over a (2, 2) grid on {dev} in "
          f"one process: {len(hb_items)} msg32 exact in {ms:.2f} ms "
          f"[{card}]", flush=True)
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    # the rendezvous is a file in a fresh directory: no port to race for
    pg_dir = tempfile.mkdtemp(prefix="chip_smoke_pg")
    root = os.path.dirname(os.path.abspath(__file__))
    procs = [ctx.Process(target=hybrid_rank, args=(
        r, HYBRID_RANKS, os.path.join(pg_dir, "pg"), root, str(dev),
        hb_items, hb_want, out))
        for r in range(HYBRID_RANKS)]
    t0 = time.perf_counter()
    for proc in procs:
        proc.start()
    reports = []
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        while len(reports) < len(procs):
            try:
                reports.append(out.get(timeout=1.0))
            except queue.Empty:
                codes = [proc.exitcode for proc in procs]
                if any(c not in (None, 0) for c in codes) or \
                        time.monotonic() > deadline:
                    raise SystemExit(f"mesh 8.4: ranks exited with {codes} "
                                     f"before reporting")
        for proc in procs:
            proc.join(60)
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.terminate()
                proc.join(10)
        shutil.rmtree(pg_dir, ignore_errors=True)
    if any(proc.exitcode != 0 for proc in procs):
        raise SystemExit(f"mesh 8.4: a rank exited with "
                         f"{[proc.exitcode for proc in procs]}")
    rows = shard_shares(len(hb_items), 2 * HYBRID_RANKS)
    for rep in sorted(reports, key=lambda x: x["rank"]):
        mine = rows[2 * rep["rank"]] + rows[2 * rep["rank"] + 1]
        if rep["mism"] or rep["n"] != len(hb_items) or \
                rep["shape"] != [HYBRID_RANKS, 2] or \
                rep["launches"] != {"msg32": 6, "k": 0, "ladder": 6} or \
                rep["sent"] != [mine + TAG_BYTES] * 3:
            raise SystemExit(f"mesh 8.4: rank {rep['rank']}: {rep}")
        paths["hybrid"].update(rep["launches"])
    print(f"mesh 8.4: {HYBRID_RANKS} spawned gloo ranks, each 2 positions on "
          f"{dev}, one {len(hb_items)}-signature msg32 batch handed to both: "
          f"then it and its reverse in flight, collected in opposite "
          f"orders: both ranks' verdicts equal the oracle; each launched its "
          f"2 shards a batch and broadcast only its rows' verdicts and the "
          f"batch tag "
          + ", ".join(f"rank {r['rank']} {r['sent']} B in {r['ms']:.1f} ms"
                      for r in sorted(reports, key=lambda x: x["rank"]))
          + f"; {(time.perf_counter() - t0):.1f} s with start-up [{card}]",
          flush=True)
    return {k: dict(c) for k, c in paths.items()}


def txset_workload(n, seed=TXSET_SEED):
    """Phase 9's ledger and txset as XDR bytes, built with the port only:
    a protocol-21 header, 2n funded accounts (n sources, n destinations)
    and n one-Payment transactions, one per source, signed by the native
    host library. A chosen mix (not measured traffic) of TXSET_MIX marks
    max(1, round(share * n)) transactions of each kind, placed by a
    seeded permutation:
    - multisig: the source has a second signer and a medium threshold of
      2; the second signature's hint is not the source's, so it misses
      the batch and goes to the fallback;
    - fee_bump: wrapped in a fee bump paid by the destination;
    - flipped: one signature byte flipped (txBAD_AUTH);
    - extra_sig: an unneeded signature of another key
      (txBAD_AUTH_EXTRA)."""
    from stellar_core_tpu_torch.crypto.keys import SecretKey
    from stellar_core_tpu_torch.crypto.sha import sha256
    from stellar_core_tpu_torch.tx.frame import make_frame
    from stellar_core_tpu_torch.tx.tx_utils import (
        make_account_ledger_entry, starting_sequence_number)
    from stellar_core_tpu_torch.xdr.ledger import LedgerHeader, StellarValue
    from stellar_core_tpu_torch.xdr.ledger_entries import Asset, AssetType, \
        Signer
    from stellar_core_tpu_torch.xdr.transaction import (
        DecoratedSignature, FeeBumpTransaction,
        FeeBumpTransactionEnvelope, Memo, MemoType, MuxedAccount, Operation,
        OperationType, PaymentOp, Preconditions, PreconditionType,
        Transaction, TransactionEnvelope, TransactionV1Envelope,
        _FeeBumpInnerTx, _OperationBody, _TxExt)
    from stellar_core_tpu_torch.xdr.types import (EnvelopeType, PublicKey,
                                                  SignerKey, SignerKeyType)

    rng = np.random.default_rng(seed)
    kinds = ["plain"] * n
    order = rng.permutation(n)
    at = 0
    for kind, share in TXSET_MIX:
        k = max(1, round(share * n))
        for i in order[at:at + k]:
            kinds[i] = kind
        at += k
    if at > n:
        raise ValueError(f"txset_workload: {n} transactions hold no mix")
    network_id = sha256(b"chip smoke txset network")
    header = LedgerHeader(
        ledgerVersion=21, ledgerSeq=2, baseFee=100, baseReserve=5_000_000,
        totalCoins=10 ** 18, maxTxSetSize=2 * n,
        scpValue=StellarValue(closeTime=1_700_000_000))
    seq0 = starting_sequence_number(1)

    def key():
        return SecretKey.from_seed(rng.bytes(32))

    def decorated(sk, payload):
        return DecoratedSignature(hint=sk.public_key().hint(),
                                  signature=sk.sign(payload))

    entries, envelopes = [], []
    for i in range(n):
        src, dst = key(), key()
        for sk in (src, dst):
            le = make_account_ledger_entry(
                PublicKey.ed25519(sk.public_key().raw), 1000 * XLM, seq0)
            le.lastModifiedLedgerSeq = 1
            if sk is src and kinds[i] == "multisig":
                second = key()
                acc = le.data.value
                acc.signers = [Signer(key=SignerKey(
                    SignerKeyType.SIGNER_KEY_TYPE_ED25519,
                    second.public_key().raw), weight=1)]
                acc.numSubEntries = 1
                acc.thresholds = bytes([1, 1, 2, 2])
            entries.append(le.to_bytes())
        pay = Operation(sourceAccount=None, body=_OperationBody(
            OperationType.PAYMENT, PaymentOp(
                destination=MuxedAccount.from_ed25519(dst.public_key().raw),
                asset=Asset(AssetType.ASSET_TYPE_NATIVE),
                amount=(1 + i % 97) * XLM)))
        tx = Transaction(
            sourceAccount=MuxedAccount.from_ed25519(src.public_key().raw),
            fee=100, seqNum=seq0 + 1,
            cond=Preconditions(PreconditionType.PRECOND_NONE),
            memo=Memo(MemoType.MEMO_ID, i), operations=[pay], ext=_TxExt(0))
        v1 = TransactionV1Envelope(tx=tx, signatures=[])
        env = TransactionEnvelope(EnvelopeType.ENVELOPE_TYPE_TX, v1)
        h = make_frame(env, network_id).contents_hash()
        v1.signatures.append(decorated(src, h))
        if kinds[i] == "multisig":
            v1.signatures.append(decorated(second, h))
        elif kinds[i] == "flipped":
            sig = bytearray(v1.signatures[0].signature)
            sig[int(rng.integers(64))] ^= 1 << int(rng.integers(8))
            v1.signatures[0].signature = bytes(sig)
        elif kinds[i] == "extra_sig":
            v1.signatures.append(decorated(key(), h))
        elif kinds[i] == "fee_bump":
            fb = FeeBumpTransactionEnvelope(tx=FeeBumpTransaction(
                feeSource=MuxedAccount.from_ed25519(dst.public_key().raw),
                fee=400, innerTx=_FeeBumpInnerTx(
                    EnvelopeType.ENVELOPE_TYPE_TX, v1),
                ext=_TxExt(0)), signatures=[])
            env = TransactionEnvelope(EnvelopeType.ENVELOPE_TYPE_TX_FEE_BUMP,
                                      fb)
            fb.signatures.append(
                decorated(dst, make_frame(env, network_id).contents_hash()))
        envelopes.append(env.to_bytes())
    return {"header": header.to_bytes(), "entries": entries,
            "envelopes": envelopes, "network_id": network_id,
            "kinds": kinds}


class RecordingVerifier:
    """Passes verify_tuples and verify_tuples_async to `inner` (an async
    call to its verify_tuples where it has no async form) and keeps each
    call, in the order of dispatch, as [tuples, verdicts, wall time]; an
    async call's verdicts and wall, from dispatch to collected, are
    filled in when it is collected."""

    def __init__(self, inner):
        self.inner = inner
        self.calls = []

    def verify_tuples(self, items):
        t0 = time.perf_counter()
        out = self.inner.verify_tuples(items)
        self.calls.append([list(items), list(out),
                           time.perf_counter() - t0])
        return out

    def verify_tuples_async(self, items):
        call = [list(items), None, None]
        self.calls.append(call)
        t0 = time.perf_counter()
        if hasattr(self.inner, "verify_tuples_async"):
            collect = self.inner.verify_tuples_async(items)
        else:
            out = self.inner.verify_tuples(items)

            def collect():
                return out

        def done():
            got = collect()
            call[1], call[2] = list(got), time.perf_counter() - t0
            return got
        return done


def contract_meta(meta):
    """The contract events and return value an apply wrote into `meta`,
    as bytes."""
    sm = meta.get("soroban") or {}
    rv = sm.get("return_value")
    return ([e.to_bytes() for e in sm.get("events", [])],
            None if rv is None else rv.to_bytes())


def txset_run(wl, batch_verifier=None, apply_batch=None, invariants=False,
              events=False):
    """The node's txset validation and apply on a fresh root from the
    workload's bytes. With `batch_verifier`, signatures go through
    `_LazyBatchPrevalidator(batch_verifier, ...)`, the herder's per-txset
    device batch, after the verify cache is cleared, and the set is
    validated a second time through a fresh prevalidator (the cache is
    then seeded, so that one must dispatch nothing); without it, through
    `default_verify`, the native per-signature path. Then
    `trim_invalid`, a set of the valid transactions, and its apply in
    `get_txs_in_apply_order`: every fee, then every transaction, in one
    LedgerTxn over the next ledger's header, which commits.

    With `apply_batch`, the apply verifies as catchup's does
    (stellar_core_tpu/catchup/catchup_work.py:566-643): the valid
    transactions' tuples collected with the network id (envelope and
    Soroban auth-entry signatures) go to `apply_batch.verify_tuples` in
    one call, and a `PrevalidatedVerifier` of its results is the apply's
    `verify`. Every result is also written through to the process verify
    cache, as the herder's prevalidator does, since the host's auth
    check verifies through that cache and not through `verify`; the
    cache's hits and misses during the apply are returned. With
    `invariants`, the apply runs under every default invariant; with
    `events`, each applied transaction's contract events and return
    value are kept, as bytes."""
    from stellar_core_tpu_torch.crypto.keys import (clear_verify_cache,
                                                    flush_verify_cache_counts,
                                                    seed_verify_cache)
    from stellar_core_tpu_torch.crypto.sha import sha256
    from stellar_core_tpu_torch.herder.herder import _LazyBatchPrevalidator
    from stellar_core_tpu_torch.herder.tx_set import (
        make_tx_set_from_transactions, trim_invalid)
    from stellar_core_tpu_torch.invariant import (InvariantManager,
                                                  register_default_invariants)
    from stellar_core_tpu_torch.ledger.ledger_txn import (
        InMemoryLedgerTxnRoot, LedgerTxn)
    from stellar_core_tpu_torch.tx.frame import make_frame
    from stellar_core_tpu_torch.tx.signature_checker import (
        PrevalidatedVerifier, collect_signature_tuples, default_verify)
    from stellar_core_tpu_torch.xdr.ledger_entries import LedgerEntryType
    from stellar_core_tpu_torch.xdr.transaction import TransactionEnvelope

    out = {}
    clear_verify_cache()
    root = InMemoryLedgerTxnRoot.from_xdr(wl["header"], wl["entries"])
    nid = wl["network_id"]
    frames = [make_frame(TransactionEnvelope.from_bytes(b), nid)
              for b in wl["envelopes"]]
    _, applicable, excluded = make_tx_set_from_transactions(
        frames, root.get_header(), nid)
    if excluded:
        raise SystemExit(f"txset: surge pricing left out {len(excluded)}")
    out["contents_hash"] = applicable.get_contents_hash()

    verify = _LazyBatchPrevalidator(batch_verifier, applicable,
                                    default_verify) \
        if batch_verifier else default_verify
    t0 = time.perf_counter()
    out["verdict"] = applicable.check_valid(root, verify=verify)
    out["validate_s"] = time.perf_counter() - t0
    if batch_verifier:
        out["first"] = verify._pv
        watched = RecordingVerifier(batch_verifier)
        again = _LazyBatchPrevalidator(watched, applicable, default_verify)
        t0 = time.perf_counter()
        out["verdict_again"] = applicable.check_valid(root, verify=again)
        out["again_s"] = time.perf_counter() - t0
        out["again"] = again._pv
        out["again_calls"] = len(watched.calls)
    t0 = time.perf_counter()
    kept, dropped = trim_invalid(applicable.txs, root, verify)
    out["trim_s"] = time.perf_counter() - t0
    out["kept"] = [t.full_hash() for t in kept]
    out["dropped"] = [t.full_hash() for t in dropped]
    out["codes"] = {t.full_hash(): t.result.to_bytes()
                    for t in applicable.txs}
    _, valid_set, _ = make_tx_set_from_transactions(kept, root.get_header(),
                                                    nid)
    order = valid_set.get_txs_in_apply_order()
    manager = None
    if invariants:
        manager = InvariantManager()
        register_default_invariants(manager)
        manager.enable([".*"])
    if apply_batch is not None:
        t0 = time.perf_counter()
        tuples = collect_signature_tuples(order, nid)
        out["apply_tuples"] = tuples
        out["apply_verdicts"] = list(apply_batch.verify_tuples(tuples))
        verify = PrevalidatedVerifier(fallback=default_verify)
        verify.add_results(tuples, out["apply_verdicts"])
        for (pub, sig, msg), ok in zip(tuples, out["apply_verdicts"]):
            seed_verify_cache(pub, sig, msg, ok)
        out["apply_batch_s"] = time.perf_counter() - t0
        flush_verify_cache_counts()
    metas = [{} if events else None for _ in order]
    t0 = time.perf_counter()
    with LedgerTxn(root) as ltx:
        ltx.load_header().ledgerSeq += 1
        for t in order:
            t.process_fee_seq_num(ltx, valid_set.base_fee_for(t))
        out["applied_ok"] = [t.apply(ltx, valid_set.base_fee_for(t),
                                     verify=verify, invariants=manager,
                                     meta=meta)
                             for t, meta in zip(order, metas)]
        ltx.commit()
    out["apply_s"] = time.perf_counter() - t0
    if events:
        out["events"] = [contract_meta(meta) for meta in metas]
    if apply_batch is not None:
        out["apply_cache"] = flush_verify_cache_counts()
        out["apply_pv"] = (verify.hits, verify.misses)
    out["root"] = root
    out["order"] = [t.full_hash() for t in order]
    out["results"] = [t.result.to_bytes() for t in order]
    out["offers"] = sum(e.data.disc == LedgerEntryType.OFFER
                        for e in root._entries.values())
    state = root.get_header().to_bytes() + b"".join(
        kb + root._lookup(kb).to_bytes() for kb in sorted(root._entries))
    out["ledger_hash"] = sha256(state)
    return out


def card_and_host_runs(card, wl):
    """Runs A and B of a txset phase on the workload `wl`: A through
    `_LazyBatchPrevalidator(BackendSupervisor(CudaBatchVerifier()))`,
    the launch counters set to 0 just before and read just after; B
    native on a fresh root from the same bytes. The oracle verdicts of
    the paired signatures come from worker processes meanwhile. Returns
    both runs, A's recorded batches, the pairs, A's launches and the
    problems that every txset phase checks: A == B, one batch equal to
    the oracle holding exactly the pairs, prep msg32 1 + ladder 1, B
    launching nothing, no call in the second validation, and the
    supervisor CLOSED with 0 failures and 0 skips."""
    from stellar_core_tpu_torch.crypto import ed25519_ref as ref
    from stellar_core_tpu_torch.ops.backend_supervisor import (
        CLOSED, BackendSupervisor)
    from stellar_core_tpu_torch.ops.verifier import CudaBatchVerifier
    from stellar_core_tpu_torch.tx.frame import make_frame
    from stellar_core_tpu_torch.tx.signature_checker import \
        collect_signature_tuples
    from stellar_core_tpu_torch.xdr.transaction import TransactionEnvelope

    nid = wl["network_id"]
    frames = [make_frame(TransactionEnvelope.from_bytes(b), nid)
              for b in wl["envelopes"]]
    paired = collect_signature_tuples(frames)
    pool = multiprocessing.get_context("spawn").Pool(
        max(1, min(7, (os.cpu_count() or 2) - 1)))
    try:
        oracle = pool.starmap_async(ref.verify, paired, chunksize=64)
        sup = BackendSupervisor(CudaBatchVerifier())
        rec = RecordingVerifier(sup)
        zero_launches()
        a = txset_run(wl, rec)
        launches = launch_counts()
        zero_launches()
        b = txset_run(wl)
        b_launches = launch_counts()
        want = oracle.get(timeout=900)
    finally:
        pool.terminate()
        pool.join()
    st = sup.status()
    sup.shutdown()
    problems = []
    for key in ("contents_hash", "verdict", "kept", "dropped", "codes",
                "order", "results", "applied_ok", "offers", "ledger_hash"):
        if a[key] != b[key]:
            problems.append(f"run A and run B differ in {key}")
    if a["verdict_again"] != a["verdict"]:
        problems.append("the second validation changed its verdict")
    if len(rec.calls) != 1:
        problems.append(f"{len(rec.calls)} verify_tuples calls, not 1")
    else:
        items, got, _ = rec.calls[0]
        if sorted(items) != sorted(paired):
            problems.append(f"the batch holds {len(items)} tuples, not the "
                            f"{len(paired)} collect_signature_tuples pairs")
        oracle = dict(zip(paired, want))
        off = sum(g != oracle.get(t) for g, t in zip(got, items))
        if off:
            problems.append(f"{off} device verdicts differ from the oracle")
    if launches != {"msg32": 1, "k": 0, "ladder": 1}:
        problems.append(f"run A launched {launches}, not prep 1 + ladder 1")
    if any(b_launches.values()):
        problems.append(f"run B launched {b_launches}")
    if a["again_calls"] or a["again"].hits == 0:
        problems.append(f"the second validation made {a['again_calls']} "
                        f"verify_tuples calls and {a['again'].hits} table "
                        "hits; the seeded cache should serve the batch")
    if st["state"] != CLOSED or any(st["failures"].values()) or \
            st["skips"] or st["transitions"]:
        problems.append(f"supervisor: {st['state']}, failures "
                        f"{st['failures']}, skips {st['skips']}, "
                        f"transitions {st['transitions']}")
    return a, b, rec, paired, launches, problems


def kinds_by_hash(wl):
    from stellar_core_tpu_torch.tx.frame import make_frame
    from stellar_core_tpu_torch.xdr.transaction import TransactionEnvelope
    return {make_frame(TransactionEnvelope.from_bytes(e), wl["network_id"])
            .full_hash(): k for e, k in zip(wl["envelopes"], wl["kinds"])}


def dropped_problems(a, by_hash, bad):
    """A problem if the dropped transactions are not exactly those of
    the kinds in `bad` (kind -> the TransactionResultCode each must
    end with)."""
    from stellar_core_tpu_torch.xdr.results import TransactionResult
    problems = []
    for h, code in a["codes"].items():
        k = by_hash[h]
        got_code = TransactionResult.from_bytes(code).result.disc
        if (h in a["dropped"]) != (k in bad) or \
                (k in bad and got_code != bad[k]):
            problems.append(f"a {k} transaction ended {got_code!r}")
            break
    return problems


def txset_phase(card):
    """Phase 9: the node's txset validation on the card at the size of
    BASELINE.json config #2 (TXSET_N one-Payment transactions, 2 x
    TXSET_N funded accounts). Run A: BackendSupervisor(
    CudaBatchVerifier()) under the herder's lazy prevalidator; run B:
    the native per-signature path on a fresh root from the same bytes.
    Returns the launches of run A by kernel."""
    from stellar_core_tpu_torch.xdr.results import TransactionResultCode

    t0 = time.perf_counter()
    wl = txset_workload(TXSET_N)
    build_s = time.perf_counter() - t0
    a, b, rec, paired, launches, problems = card_and_host_runs(card, wl)
    problems += dropped_problems(a, kinds_by_hash(wl), {
        "flipped": TransactionResultCode.txBAD_AUTH,
        "extra_sig": TransactionResultCode.txBAD_AUTH_EXTRA})
    if not all(a["applied_ok"]):
        problems.append(f"{a['applied_ok'].count(False)} valid transactions "
                        "failed to apply")
    if problems:
        raise SystemExit("txset: " + "; ".join(problems))
    counts = collections.Counter(wl["kinds"])
    first = a["first"]
    print(f"txset: {TXSET_N} one-Payment transactions over {2 * TXSET_N} "
          f"accounts, chosen mix {dict(counts)}; built in {build_s:.3f} s; "
          f"validation A (card) {a['validate_s'] * 1e3:.1f} ms, of it the "
          f"device dispatch {rec.calls[0][2] * 1e3:.2f} ms "
          f"({len(paired)} signatures, prep 1 + ladder 1), validation B "
          f"(host) {b['validate_s'] * 1e3:.1f} ms (each stops at the first "
          f"invalid transaction); trim_invalid, every transaction: A "
          f"{a['trim_s'] * 1e3:.1f} ms, B {b['trim_s'] * 1e3:.1f} ms; again "
          f"with the cache seeded {a['again_s'] * 1e3:.1f} ms, 0 launches; "
          f"apply of "
          f"{len(a['kept'])} valid {a['apply_s'] * 1e3:.1f} ms (A) / "
          f"{b['apply_s'] * 1e3:.1f} ms (B); dropped {len(a['dropped'])} "
          f"[{card}]", flush=True)
    print(f"txset: prevalidator hits {first.hits}, misses {first.misses} "
          f"(second validation: hits {a['again'].hits}, misses "
          f"{a['again'].misses}); runs A and B equal on verdicts, trim, "
          f"results and ledger hash {a['ledger_hash'].hex()[:16]}; the "
          f"batch equals the oracle on all {len(paired)} tuples; supervisor "
          f"CLOSED, 0 failures, 0 skips [{card}]", flush=True)
    return launches


def classic_workload(n, seed=CLASSIC_SEED):
    """Phase 10's ledger and txset as XDR bytes, built with the port only.
    The ledger is what the JAX package's load generator leaves after
    `setup_dex` (simulation/load_generator.py:242-259), at protocol 21:
    an issuer of LOAD and n source accounts of 1,000 XLM, each with an
    authorized LOAD trustline (limit 2^62, balance 1,000 LOAD) and
    numSubEntries 1. One transaction per source at seq + 1, signed by
    the native host library; CLASSIC_MIX marks max(1, round(share * n))
    of each kind by a seeded permutation, the rest are payments (a
    chosen mix of the generator's modes, not measured traffic):
    - offer: MIXED_CLASSIC's ManageSellOffer (`generate_mixed`), 10,000
      stroops of XLM for LOAD at (100 + i mod 32) / 100, offer ID 0; all
      on one side of the book, so they rest;
    - payment: MIXED_CLASSIC's native Payment of 10,000 stroops to the
      next source;
    - pretend: PRETEND's three operations (`generate_pretend`,
      ops_per_tx 3): SetOptions with a home domain, ManageData with a
      32-byte SHA-256 value, SetOptions;
    - path: PathPaymentStrictSend of 100 stroops of LOAD for at least 1
      stroop of XLM to the next source, crossing the offers applied
      before it (it fails with a failed-op result where none was);
    - create: CreateAccount of a fresh key with 10 XLM;
    - change_trust: setup_dex's ChangeTrust (limit 2^62) to a second
      asset of the same issuer;
    - flipped: a payment with one signature byte flipped (txBAD_AUTH)."""
    from stellar_core_tpu_torch.crypto.keys import SecretKey
    from stellar_core_tpu_torch.crypto.sha import sha256
    from stellar_core_tpu_torch.tx.frame import make_frame
    from stellar_core_tpu_torch.tx.tx_utils import (
        make_account_ledger_entry, starting_sequence_number)
    from stellar_core_tpu_torch.xdr.ledger import LedgerHeader, StellarValue
    from stellar_core_tpu_torch.xdr.ledger_entries import (
        Asset, AssetType, LedgerEntry, LedgerEntryType, Price,
        TrustLineAsset, TrustLineEntry, TrustLineFlags, _LedgerEntryData)
    from stellar_core_tpu_torch.xdr.transaction import (
        ChangeTrustAsset, ChangeTrustOp, CreateAccountOp, DecoratedSignature,
        ManageDataOp, ManageSellOfferOp, Memo, MemoType, MuxedAccount,
        Operation, OperationType, PathPaymentStrictSendOp, PaymentOp,
        Preconditions, PreconditionType, SetOptionsOp, Transaction,
        TransactionEnvelope, TransactionV1Envelope, _OperationBody, _TxExt)
    from stellar_core_tpu_torch.xdr.types import EnvelopeType, PublicKey

    rng = np.random.default_rng(seed)
    kinds = ["payment"] * n
    order = rng.permutation(n)
    at = 0
    for kind, share in CLASSIC_MIX:
        k = max(1, round(share * n))
        for i in order[at:at + k]:
            kinds[i] = kind
        at += k
    if at > n:
        raise ValueError(f"classic_workload: {n} transactions hold no mix")
    network_id = sha256(b"chip smoke classic network")
    header = LedgerHeader(
        ledgerVersion=21, ledgerSeq=2, baseFee=100, baseReserve=5_000_000,
        totalCoins=10 ** 18, maxTxSetSize=3 * n,
        scpValue=StellarValue(closeTime=1_700_000_000))
    seq0 = starting_sequence_number(1)

    def key():
        return SecretKey.from_seed(rng.bytes(32))

    def account_id(sk):
        return PublicKey.ed25519(sk.public_key().raw)

    def op(kind, body):
        return Operation(sourceAccount=None, body=_OperationBody(kind, body))

    issuer = key()
    load = Asset.credit(b"LOAD", account_id(issuer))
    alt = Asset.credit(b"ALT", account_id(issuer))
    native = Asset(AssetType.ASSET_TYPE_NATIVE)
    le = make_account_ledger_entry(account_id(issuer), 1000 * XLM, seq0)
    le.lastModifiedLedgerSeq = 1
    entries = [le.to_bytes()]
    sources = [key() for _ in range(n)]
    for sk in sources:
        le = make_account_ledger_entry(account_id(sk), 1000 * XLM, seq0)
        le.lastModifiedLedgerSeq = 1
        le.data.value.numSubEntries = 1
        line = LedgerEntry(lastModifiedLedgerSeq=1, data=_LedgerEntryData(
            LedgerEntryType.TRUSTLINE, TrustLineEntry(
                accountID=account_id(sk),
                asset=TrustLineAsset.from_asset(load), balance=1000 * XLM,
                limit=2 ** 62, flags=int(TrustLineFlags.AUTHORIZED_FLAG))))
        entries += [le.to_bytes(), line.to_bytes()]

    envelopes = []
    for i, (sk, kind) in enumerate(zip(sources, kinds)):
        nxt = MuxedAccount.from_ed25519(sources[(i + 1) % n].public_key().raw)
        if kind == "offer":
            ops = [op(OperationType.MANAGE_SELL_OFFER, ManageSellOfferOp(
                selling=native, buying=load, amount=10_000,
                price=Price(n=100 + i % 32, d=100), offerID=0))]
        elif kind == "pretend":
            ops = [op(OperationType.SET_OPTIONS, SetOptionsOp(
                       homeDomain=b"pretend-00.example.com")),
                   op(OperationType.MANAGE_DATA, ManageDataOp(
                       dataName=b"load01",
                       dataValue=sha256(b"pretend-%d-1" % i))),
                   op(OperationType.SET_OPTIONS, SetOptionsOp(
                       homeDomain=b"pretend-02.example.com"))]
        elif kind == "path":
            ops = [op(OperationType.PATH_PAYMENT_STRICT_SEND,
                      PathPaymentStrictSendOp(
                          sendAsset=load, sendAmount=100, destination=nxt,
                          destAsset=native, destMin=1, path=[]))]
        elif kind == "create":
            ops = [op(OperationType.CREATE_ACCOUNT, CreateAccountOp(
                destination=account_id(key()), startingBalance=10 * XLM))]
        elif kind == "change_trust":
            ops = [op(OperationType.CHANGE_TRUST, ChangeTrustOp(
                line=ChangeTrustAsset(alt.disc, alt.value), limit=2 ** 62))]
        else:                               # payment, flipped
            ops = [op(OperationType.PAYMENT, PaymentOp(
                destination=nxt, asset=native, amount=10_000))]
        tx = Transaction(
            sourceAccount=MuxedAccount.from_ed25519(sk.public_key().raw),
            fee=100 * len(ops), seqNum=seq0 + 1,
            cond=Preconditions(PreconditionType.PRECOND_NONE),
            memo=Memo(MemoType.MEMO_NONE), operations=ops, ext=_TxExt(0))
        v1 = TransactionV1Envelope(tx=tx, signatures=[])
        env = TransactionEnvelope(EnvelopeType.ENVELOPE_TYPE_TX, v1)
        h = make_frame(env, network_id).contents_hash()
        sig = bytearray(sk.sign(h))
        if kind == "flipped":
            sig[int(rng.integers(64))] ^= 1 << int(rng.integers(8))
        v1.signatures.append(DecoratedSignature(
            hint=sk.public_key().hint(), signature=bytes(sig)))
        envelopes.append(env.to_bytes())
    return {"header": header.to_bytes(), "entries": entries,
            "envelopes": envelopes, "network_id": network_id,
            "kinds": kinds}


def classic_outcomes(a, by_hash):
    """Run A's apply by operation: {(op type, result code): count}, the
    transactions that failed at apply by kind, and the path payments
    that crossed at least one offer (a non-empty ClaimAtom list)."""
    from stellar_core_tpu_torch.xdr.results import (OperationResultCode,
                                                    TransactionResult)
    from stellar_core_tpu_torch.xdr.transaction import OperationType
    codes, failed, crossed = collections.Counter(), collections.Counter(), 0
    for h, ok, raw in zip(a["order"], a["applied_ok"], a["results"]):
        if not ok:
            failed[by_hash[h]] += 1
        res = TransactionResult.from_bytes(raw).result.value
        for r in res if isinstance(res, list) else []:
            if r.disc != OperationResultCode.opINNER:
                codes[(by_hash[h], r.disc.name)] += 1
                continue
            tr = r.value
            codes[(tr.disc.name, tr.value.disc.name)] += 1
            if tr.disc == OperationType.PATH_PAYMENT_STRICT_SEND and \
                    tr.value.disc == 0 and tr.value.value.offers:
                crossed += 1
    return codes, failed, crossed


def classic_phase(card):
    """Phase 10: the classic operation families on the card's txset path
    at the size of BASELINE.json config #2: CLASSIC_N transactions of the
    load generator's MIXED_CLASSIC and PRETEND modes over what its
    setup_dex leaves (classic_workload). Runs A and B as phase 9's.
    Returns the launches of run A by kernel."""
    from stellar_core_tpu_torch.xdr.results import TransactionResultCode

    t0 = time.perf_counter()
    wl = classic_workload(CLASSIC_N)
    build_s = time.perf_counter() - t0
    a, b, rec, paired, launches, problems = card_and_host_runs(card, wl)
    by_hash = kinds_by_hash(wl)
    problems += dropped_problems(a, by_hash, {
        "flipped": TransactionResultCode.txBAD_AUTH})
    codes, failed, crossed = classic_outcomes(a, by_hash)
    if set(failed) - {"path"}:
        problems.append(f"transactions failed at apply: {dict(failed)}; "
                        "only a path payment with no offer before it may")
    if not crossed:
        problems.append("no path payment crossed an offer")
    kinds = collections.Counter(wl["kinds"])
    if a["offers"] != kinds["offer"]:
        problems.append(f"{a['offers']} offers rest after apply, not the "
                        f"{kinds['offer']} created")
    if problems:
        raise SystemExit("classic: " + "; ".join(problems))
    first = a["first"]
    print(f"classic: {CLASSIC_N} transactions ({len(a['kept'])} valid) of "
          f"the load generator's "
          f"MIXED_CLASSIC and PRETEND modes over {len(wl['entries'])} "
          f"entries, chosen mix {dict(kinds)}; built in {build_s:.3f} s; "
          f"validation A (card) {a['validate_s'] * 1e3:.1f} ms, of it the "
          f"device dispatch {rec.calls[0][2] * 1e3:.2f} ms "
          f"({len(paired)} signatures, prep 1 + ladder 1), validation B "
          f"(host) {b['validate_s'] * 1e3:.1f} ms; trim_invalid A "
          f"{a['trim_s'] * 1e3:.1f} ms, B {b['trim_s'] * 1e3:.1f} ms; again "
          f"with the cache seeded {a['again_s'] * 1e3:.1f} ms, 0 launches; "
          f"apply A {a['apply_s'] * 1e3:.1f} ms, B {b['apply_s'] * 1e3:.1f} "
          f"ms; dropped {len(a['dropped'])} [{card}]", flush=True)
    print("classic: results by operation "
          + ", ".join(f"{op} {code} {c}" for (op, code), c
                      in sorted(codes.items()))
          + f"; failed at apply {dict(failed)}; {crossed} of "
          f"{kinds['path']} path payments crossed offers; {a['offers']} "
          f"offers rest after apply", flush=True)
    print(f"classic: prevalidator hits {first.hits}, misses {first.misses} "
          f"(second validation: hits {a['again'].hits}, misses "
          f"{a['again'].misses}); runs A and B equal on verdicts, trim, "
          f"results, offers and ledger hash {a['ledger_hash'].hex()[:16]}; "
          f"the batch equals the oracle on all {len(paired)} tuples; "
          f"supervisor CLOSED, 0 failures, 0 skips [{card}]", flush=True)
    return launches


def mixed_kinds(rng, n, mix, rest, tag):
    """The kind of each of n transactions: `mix` marks max(1, round(share
    * n)) of each of its kinds by a seeded permutation, the rest are
    `rest`."""
    kinds = [rest] * n
    order = rng.permutation(n)
    at = 0
    for kind, share in mix:
        k = max(1, round(share * n))
        for i in order[at:at + k]:
            kinds[i] = kind
        at += k
    if at > n:
        raise ValueError(f"{tag}: {n} transactions hold no mix")
    return kinds


def contract_kit(rng, network_id):
    """Builders of signed InvokeHostFunction transactions on one network
    (phases 11 and 12); nonces and flipped bits come from `rng`."""
    from types import SimpleNamespace

    from stellar_core_tpu_torch.soroban.host import soroban_auth_payload
    from stellar_core_tpu_torch.tx.frame import make_frame
    from stellar_core_tpu_torch.xdr import contract as cx
    from stellar_core_tpu_torch.xdr.transaction import (
        DecoratedSignature, Memo, MemoType, MuxedAccount, Operation,
        OperationType, Preconditions, PreconditionType, Transaction,
        TransactionEnvelope, TransactionV1Envelope, _OperationBody, _TxExt)
    from stellar_core_tpu_torch.xdr.types import EnvelopeType, PublicKey

    def account_id(sk):
        return PublicKey.ed25519(sk.public_key().raw)

    def sc_account(sk):
        return cx.SCAddress(cx.SCAddressType.SC_ADDRESS_TYPE_ACCOUNT,
                            account_id(sk))

    def envelope(source, seq, body, ro, rw, flip=False,
                 instructions=4_000_000):
        sd = cx.SorobanTransactionData(
            resources=cx.SorobanResources(
                footprint=cx.LedgerFootprint(readOnly=ro, readWrite=rw),
                instructions=instructions, readBytes=50_000,
                writeBytes=50_000),
            resourceFee=SOROBAN_RESOURCE_FEE)
        tx = Transaction(
            sourceAccount=MuxedAccount.from_ed25519(source.public_key().raw),
            fee=100 + SOROBAN_RESOURCE_FEE, seqNum=seq,
            cond=Preconditions(PreconditionType.PRECOND_NONE),
            memo=Memo(MemoType.MEMO_NONE),
            operations=[Operation(sourceAccount=None, body=_OperationBody(
                OperationType.INVOKE_HOST_FUNCTION, body))],
            ext=_TxExt(1, sd))
        v1 = TransactionV1Envelope(tx=tx, signatures=[])
        env = TransactionEnvelope(EnvelopeType.ENVELOPE_TYPE_TX, v1)
        sig = bytearray(source.sign(make_frame(env, network_id)
                                    .contents_hash()))
        if flip:
            sig[int(rng.integers(64))] ^= 1 << int(rng.integers(8))
        v1.signatures.append(DecoratedSignature(
            hint=source.public_key().hint(), signature=bytes(sig)))
        return env

    def invoke(contract, fn, args, auth):
        return cx.InvokeHostFunctionOp(hostFunction=cx.HostFunction(
            cx.HostFunctionType.HOST_FUNCTION_TYPE_INVOKE_CONTRACT,
            cx.InvokeContractArgs(contractAddress=contract,
                                  functionName=fn, args=list(args))),
            auth=auth)

    def invocation(contract, fn, args):
        return cx.SorobanAuthorizedInvocation(
            function=cx.SorobanAuthorizedFunction(
                cx.SorobanAuthorizedFunctionType
                .SOROBAN_AUTHORIZED_FUNCTION_TYPE_CONTRACT_FN,
                cx.InvokeContractArgs(contractAddress=contract,
                                      functionName=fn, args=list(args))),
            subInvocations=[])

    def source_auth(root_inv):
        return cx.SorobanAuthorizationEntry(
            credentials=cx.SorobanCredentials(
                cx.SorobanCredentialsType.SOROBAN_CREDENTIALS_SOURCE_ACCOUNT),
            rootInvocation=root_inv)

    def address_auth(sk, root_inv, expiration, flip=False):
        nonce = int(rng.integers(0, 2 ** 62))
        sig = bytearray(sk.sign(soroban_auth_payload(
            network_id, nonce, expiration, root_inv)))
        if flip:
            sig[int(rng.integers(64))] ^= 1 << int(rng.integers(8))
        sig_map = cx.SCVal(cx.SCValType.SCV_MAP, [
            cx.SCMapEntry(key=cx.SCVal(cx.SCValType.SCV_SYMBOL,
                                       b"public_key"),
                          val=cx.SCVal(cx.SCValType.SCV_BYTES,
                                       sk.public_key().raw)),
            cx.SCMapEntry(key=cx.SCVal(cx.SCValType.SCV_SYMBOL,
                                       b"signature"),
                          val=cx.SCVal(cx.SCValType.SCV_BYTES, bytes(sig)))])
        return cx.SorobanAuthorizationEntry(
            credentials=cx.SorobanCredentials(
                cx.SorobanCredentialsType.SOROBAN_CREDENTIALS_ADDRESS,
                cx.SorobanAddressCredentials(
                    address=sc_account(sk), nonce=nonce,
                    signatureExpirationLedger=expiration,
                    signature=cx.SCVal(cx.SCValType.SCV_VEC, [sig_map]))),
            rootInvocation=root_inv)

    def host_fn(kind, value):
        return cx.InvokeHostFunctionOp(
            hostFunction=cx.HostFunction(kind, value), auth=[])

    return SimpleNamespace(account_id=account_id, sc_account=sc_account,
                           envelope=envelope, invoke=invoke,
                           invocation=invocation, source_auth=source_auth,
                           address_auth=address_auth, host_fn=host_fn)


def contract_ledger(rng, kit, n):
    """A protocol-21 ledger (ledgerSeq 2) with the CONFIG_SETTING entries
    of `create_initial_settings` (its default limits: this path enforces
    no per-ledger limit), a deployer, n relayers and n holders of 1,000
    XLM each, keys drawn from `rng` in that order. Returns the root, the
    header, the accounts' sequence number and the three kinds of keys."""
    from stellar_core_tpu_torch.crypto.keys import SecretKey
    from stellar_core_tpu_torch.ledger.ledger_txn import (
        InMemoryLedgerTxnRoot, LedgerTxn)
    from stellar_core_tpu_torch.soroban.network_config import \
        create_initial_settings
    from stellar_core_tpu_torch.tx.tx_utils import (
        make_account_ledger_entry, starting_sequence_number)
    from stellar_core_tpu_torch.xdr.ledger import LedgerHeader, StellarValue

    header = LedgerHeader(
        ledgerVersion=21, ledgerSeq=2, baseFee=100, baseReserve=5_000_000,
        totalCoins=10 ** 18, maxTxSetSize=2 * n,
        scpValue=StellarValue(closeTime=1_700_000_000))
    seq0 = starting_sequence_number(1)

    def key():
        return SecretKey.from_seed(rng.bytes(32))

    deployer = key()
    relayers = [key() for _ in range(n)]
    holders = [key() for _ in range(n)]
    root = InMemoryLedgerTxnRoot(header)
    with LedgerTxn(root) as ltx:
        create_initial_settings(ltx)
        for sk in [deployer] + relayers + holders:
            le = make_account_ledger_entry(kit.account_id(sk), 1000 * XLM,
                                           seq0)
            le.lastModifiedLedgerSeq = 1
            ltx.create(le)
        ltx.commit()
    return root, header, seq0, deployer, relayers, holders


def apply_setup(root, kit, network_id, deployer, seq0, setup, tag):
    """Apply the deployer's setup transactions ((body, read-only,
    read-write footprint) each, sequence numbers from seq0 + 1) to
    `root`, each required to succeed."""
    from stellar_core_tpu_torch.ledger.ledger_txn import LedgerTxn
    from stellar_core_tpu_torch.tx.frame import make_frame
    for j, (body, ro, rw) in enumerate(setup):
        frame = make_frame(kit.envelope(deployer, seq0 + 1 + j, body, ro,
                                        rw), network_id)
        with LedgerTxn(root) as ltx:
            frame.process_fee_seq_num(ltx, 100)
            ok = frame.apply(ltx, 100)
            ltx.commit()
        if not ok:
            raise SystemExit(f"{tag} setup transaction {j} failed: "
                             f"{frame.result.result.disc!r}")


def deploy_wasm_args(kit, network_id, deployer, code, salt):
    """The setup of one contract: its upload and its create from the
    deployer's address with `salt`, as (body, ro, rw) pairs; and the
    contract's address and code key."""
    from stellar_core_tpu_torch.crypto.sha import sha256
    from stellar_core_tpu_torch.soroban.host import (
        contract_id_from_preimage, instance_key)
    from stellar_core_tpu_torch.xdr import contract as cx
    from stellar_core_tpu_torch.xdr.ledger_entries import LedgerKey

    code_key = LedgerKey.contract_code(sha256(code))
    preimage = cx.ContractIDPreimage(
        cx.ContractIDPreimageType.CONTRACT_ID_PREIMAGE_FROM_ADDRESS,
        cx._ContractIDPreimageFromAddress(
            address=kit.sc_account(deployer), salt=salt))
    addr = cx.SCAddress(cx.SCAddressType.SC_ADDRESS_TYPE_CONTRACT,
                        contract_id_from_preimage(network_id, preimage))
    create = cx.CreateContractArgs(
        contractIDPreimage=preimage, executable=cx.ContractExecutable(
            cx.ContractExecutableType.CONTRACT_EXECUTABLE_WASM,
            sha256(code)))
    HF = cx.HostFunctionType
    create_body = kit.host_fn(HF.HOST_FUNCTION_TYPE_CREATE_CONTRACT, create)
    create_body.auth = [kit.source_auth(cx.SorobanAuthorizedInvocation(
        function=cx.SorobanAuthorizedFunction(
            cx.SorobanAuthorizedFunctionType
            .SOROBAN_AUTHORIZED_FUNCTION_TYPE_CREATE_CONTRACT_HOST_FN,
            create), subInvocations=[]))]
    setup = [(kit.host_fn(HF.HOST_FUNCTION_TYPE_UPLOAD_CONTRACT_WASM, code),
              [], [code_key]),
             (create_body, [code_key], [instance_key(addr)])]
    return setup, addr, code_key


def soroban_workload(n, seed=SOROBAN_SEED):
    """Phase 11's ledger and txset as XDR bytes, built with the port only
    (BASELINE.json config #4, contract-heavy ledgers). The ledger of
    `contract_ledger`; the deployer's three setup transactions are
    applied to it, each required to succeed: the native-asset SAC
    created by a CREATE_CONTRACT transaction (the load generator's
    `setup_sac`), then an SCVM contract uploaded and created whose
    `auth_bump(addr)` calls require_auth(addr) and emits an event
    (tests/test_soroban.py).
    Then n transactions, one InvokeHostFunction each, the load
    generator's `generate_sac_transfers` with address credentials; a
    chosen mix (not measured traffic), SOROBAN_MIX marking max(1,
    round(share * n)) of each kind by a seeded permutation:
    - sac_addr (the rest): relayer i submits native-SAC transfer(holder
      i, holder i + 1, 100 stroops); holder i authorizes it with an
      address-credential entry (a fresh nonce, signatureExpirationLedger
      ledgerSeq + 100, a {public_key, signature} map over
      `soroban_auth_payload`): one auth tuple;
    - sac_source: holder i submits the transfer with source-account
      credentials, the load generator's form: no auth tuple;
    - scvm: relayer i submits auth_bump(holder i) with holder i's
      address credentials: one auth tuple;
    - bad_auth: a sac_addr with one bit of the auth signature flipped;
    - expired: a sac_addr whose signatureExpirationLedger is below the
      ledger it applies in; its signature is valid;
    - flipped: a sac_source with one bit of its envelope signature
      flipped (txBAD_AUTH)."""
    from stellar_core_tpu_torch.crypto.sha import sha256
    from stellar_core_tpu_torch.soroban import scvm
    from stellar_core_tpu_torch.soroban.host import (
        contract_id_from_preimage, instance_key)
    from stellar_core_tpu_torch.soroban.sac import _addr_scval, sc_i128
    from stellar_core_tpu_torch.xdr import contract as cx
    from stellar_core_tpu_torch.xdr.ledger_entries import (Asset, AssetType,
                                                           LedgerKey)

    rng = np.random.default_rng(seed)
    kinds = mixed_kinds(rng, n, SOROBAN_MIX, "sac_addr", "soroban_workload")
    network_id = sha256(b"chip smoke soroban network")
    kit = contract_kit(rng, network_id)
    root, header, seq0, deployer, relayers, holders = \
        contract_ledger(rng, kit, n)

    # setup: the native SAC, then the SCVM contract's upload and create
    preimage = cx.ContractIDPreimage(
        cx.ContractIDPreimageType.CONTRACT_ID_PREIMAGE_FROM_ASSET,
        Asset(AssetType.ASSET_TYPE_NATIVE))
    sac = cx.SCAddress(cx.SCAddressType.SC_ADDRESS_TYPE_CONTRACT,
                       contract_id_from_preimage(network_id, preimage))
    code = scvm.make_code({"auth_bump": scvm.op(
        scvm.sym("seq"),
        scvm.op(scvm.sym("require_auth"), scvm.op(scvm.sym("arg"),
                                                  scvm.u64(0))),
        scvm.op(scvm.sym("event"),
                scvm.op(scvm.sym("lit"), scvm.sym("bumped")),
                scvm.u64(1)))})
    bump_setup, bump, code_key = deploy_wasm_args(kit, network_id, deployer,
                                                  code, b"\x01" * 32)
    setup = [(kit.host_fn(
        cx.HostFunctionType.HOST_FUNCTION_TYPE_CREATE_CONTRACT,
        cx.CreateContractArgs(
            contractIDPreimage=preimage, executable=cx.ContractExecutable(
                cx.ContractExecutableType.CONTRACT_EXECUTABLE_STELLAR_ASSET))),
        [], [instance_key(sac)])] + bump_setup
    apply_setup(root, kit, network_id, deployer, seq0, setup, "soroban")

    envelopes = []
    expire_ok, expire_past = header.ledgerSeq + 100, header.ledgerSeq - 1
    for i, kind in enumerate(kinds):
        holder, nxt = holders[i], holders[(i + 1) % n]
        if kind == "scvm":
            args = [_addr_scval(kit.sc_account(holder))]
            auth = kit.address_auth(
                holder, kit.invocation(bump, b"auth_bump", args), expire_ok)
            env = kit.envelope(relayers[i], seq0 + 1,
                               kit.invoke(bump, b"auth_bump", args, [auth]),
                               [code_key, instance_key(bump)], [])
        else:
            args = [_addr_scval(kit.sc_account(holder)),
                    _addr_scval(kit.sc_account(nxt)), sc_i128(100)]
            root_inv = kit.invocation(sac, b"transfer", args)
            rw = [LedgerKey.account(kit.account_id(holder)),
                  LedgerKey.account(kit.account_id(nxt))]
            if kind in ("sac_source", "flipped"):
                env = kit.envelope(holder, seq0 + 1,
                                   kit.invoke(sac, b"transfer", args,
                                              [kit.source_auth(root_inv)]),
                                   [instance_key(sac)], rw,
                                   flip=kind == "flipped")
            else:
                auth = kit.address_auth(
                    holder, root_inv,
                    expire_past if kind == "expired" else expire_ok,
                    flip=kind == "bad_auth")
                env = kit.envelope(relayers[i], seq0 + 1,
                                   kit.invoke(sac, b"transfer", args, [auth]),
                                   [instance_key(sac)], rw)
        envelopes.append(env.to_bytes())
    return {"header": root.get_header().to_bytes(),
            "entries": [e.to_bytes() for e in root._entries.values()],
            "envelopes": envelopes, "network_id": network_id,
            "kinds": kinds,
            "holders": [kit.account_id(sk).to_bytes() for sk in holders]}


def loadgen_counter_code():
    """The wasm build of the load generator's counter contract, the one
    `setup_counter_contract` deploys and `generate_counter_invokes` calls
    (stellar_core_tpu/simulation/load_generator.py:386-407): the scvm_wasm
    compiler's "x" host ABI."""
    from stellar_core_tpu_torch.soroban import scvm
    from stellar_core_tpu_torch.soroban.scvm_wasm import make_wasm_code
    from stellar_core_tpu_torch.xdr import contract as cx

    def count():
        return scvm.op(scvm.sym("get"), scvm.op(scvm.sym("lit"),
                                                scvm.sym("count")))

    return make_wasm_code({"increment": scvm.op(
        scvm.sym("put"), scvm.op(scvm.sym("lit"), scvm.sym("count")),
        scvm.op(scvm.sym("add"),
                scvm.op(scvm.sym("if"),
                        scvm.op(scvm.sym("eq"), count(),
                                cx.SCVal(cx.SCValType.SCV_VOID)),
                        scvm.u64(0), count()),
                scvm.u64(1)))})


def wasm_workload(n, seed=WASM_SEED):
    """Phase 12's ledger and txset as XDR bytes, built with the port only
    (BASELINE.json config #4 with wasm contracts). The ledger of
    `contract_ledger`; the deployer uploads and creates three wasm
    contracts by transactions, each required to succeed: the env-ABI
    counter (`build_env_counter`: `auth_bump(addr)` calls require_auth
    and emits an event), the env-ABI toolkit (`build_env_toolkit`:
    `sig_demo(pub, msg, sig)` calls verify_sig_ed25519) and the load
    generator's counter (`loadgen_counter_code`, the "x" ABI).
    Then n transactions, one InvokeHostFunction each, from relayer i; a
    chosen mix (not measured traffic), WASM_MIX marking max(1,
    round(share * n)) of each kind by a seeded permutation:
    - env_auth (the rest): env counter auth_bump(holder i), authorized
      by holder i's address-credential entry (a fresh nonce,
      signatureExpirationLedger ledgerSeq + 100): one auth tuple;
    - wasm_counter: the load generator's `generate_counter_invokes`
      form, `increment` on its counter with no auth entry;
    - sig_ok: toolkit sig_demo(holder i's key, a 64-byte message, holder
      i's signature of it): a contract-level verify, which the host
      makes through its own verifier (not batched);
    - sig_bad: a sig_ok with one bit of the signature flipped;
    - bad_auth: an env_auth with one bit of the auth signature flipped;
    - fuel: an env_auth whose `instructions` resource is
      WASM_FUEL_INSTRUCTIONS, one short of what it needs;
    - flipped: a wasm_counter with one bit of its envelope signature
      flipped (txBAD_AUTH).
    That budget is held on this ledger: one more instruction lets the
    first fuel transaction's call (with a fresh nonce) succeed, on a
    LedgerTxn that is rolled back; the run checks that the budget itself
    is exhausted."""
    from stellar_core_tpu_torch.crypto.sha import sha256
    from stellar_core_tpu_torch.ledger.ledger_txn import LedgerTxn
    from stellar_core_tpu_torch.soroban.env_contract import (
        build_env_counter, build_env_toolkit)
    from stellar_core_tpu_torch.soroban.host import instance_key
    from stellar_core_tpu_torch.soroban.sac import _addr_scval
    from stellar_core_tpu_torch.tx.frame import make_frame
    from stellar_core_tpu_torch.xdr import contract as cx
    from stellar_core_tpu_torch.xdr.ledger_entries import LedgerKey

    rng = np.random.default_rng(seed)
    kinds = mixed_kinds(rng, n, WASM_MIX, "env_auth", "wasm_workload")
    network_id = sha256(b"chip smoke wasm network")
    kit = contract_kit(rng, network_id)
    root, header, seq0, deployer, relayers, holders = \
        contract_ledger(rng, kit, n)
    codes = (build_env_counter(), build_env_toolkit(), loadgen_counter_code())
    setup, contracts = [], []
    for code, salt in zip(codes, (b"\x01" * 32, b"\x02" * 32,
                                  sha256(b"loadgen-counter"))):
        steps, addr, code_key = deploy_wasm_args(kit, network_id, deployer,
                                                 code, salt)
        setup += steps
        contracts.append((addr, [code_key, instance_key(addr)]))
    apply_setup(root, kit, network_id, deployer, seq0, setup, "wasm")
    (env, env_ro), (toolkit, toolkit_ro), (counter, counter_ro) = contracts
    count_key = LedgerKey.contract_data(
        counter, cx.SCVal(cx.SCValType.SCV_SYMBOL, b"count"),
        cx.ContractDataDurability.PERSISTENT)

    def sc_bytes(b):
        return cx.SCVal(cx.SCValType.SCV_BYTES, b)

    envelopes = []
    expiration = header.ledgerSeq + 100
    for i, kind in enumerate(kinds):
        holder, relayer = holders[i], relayers[i]
        if kind in ("wasm_counter", "flipped"):
            env_ = kit.envelope(relayer, seq0 + 1,
                                kit.invoke(counter, b"increment", [], []),
                                counter_ro, [count_key],
                                flip=kind == "flipped")
        elif kind in ("sig_ok", "sig_bad"):
            msg = rng.bytes(64)
            sig = bytearray(holder.sign(msg))
            if kind == "sig_bad":
                sig[int(rng.integers(64))] ^= 1 << int(rng.integers(8))
            args = [sc_bytes(holder.public_key().raw), sc_bytes(msg),
                    sc_bytes(bytes(sig))]
            env_ = kit.envelope(relayer, seq0 + 1,
                                kit.invoke(toolkit, b"sig_demo", args, []),
                                toolkit_ro, [])
        else:
            args = [_addr_scval(kit.sc_account(holder))]
            auth = kit.address_auth(
                holder, kit.invocation(env, b"auth_bump", args), expiration,
                flip=kind == "bad_auth")
            env_ = kit.envelope(
                relayer, seq0 + 1, kit.invoke(env, b"auth_bump", args,
                                              [auth]), env_ro, [],
                instructions=WASM_FUEL_INSTRUCTIONS if kind == "fuel"
                else 4_000_000)
        envelopes.append(env_.to_bytes())
    i = kinds.index("fuel")
    args = [_addr_scval(kit.sc_account(holders[i]))]
    auth = kit.address_auth(holders[i], kit.invocation(env, b"auth_bump",
                                                       args), expiration)
    probe = make_frame(kit.envelope(
        relayers[i], seq0 + 1, kit.invoke(env, b"auth_bump", args, [auth]),
        env_ro, [], instructions=WASM_FUEL_INSTRUCTIONS + 1), network_id)
    with LedgerTxn(root) as ltx:
        probe.process_fee_seq_num(ltx, 100)
        enough = probe.apply(ltx, 100)
        ltx.rollback()
    if not enough:
        raise SystemExit("wasm_workload: WASM_FUEL_INSTRUCTIONS + 1 is not "
                         f"enough: {probe.result.result!r}")
    return {"header": root.get_header().to_bytes(),
            "entries": [e.to_bytes() for e in root._entries.values()],
            "envelopes": envelopes, "network_id": network_id,
            "kinds": kinds, "codes": [sha256(c) for c in codes],
            "count_key": count_key.to_bytes(),
            "holders": [kit.account_id(sk).to_bytes() for sk in holders]}


# the result of each applied kind of phase 12 (flipped is dropped)
WASM_RESULTS = {"env_auth": "INVOKE_HOST_FUNCTION_SUCCESS",
                "wasm_counter": "INVOKE_HOST_FUNCTION_SUCCESS",
                "sig_ok": "INVOKE_HOST_FUNCTION_SUCCESS",
                "sig_bad": "INVOKE_HOST_FUNCTION_TRAPPED",
                "bad_auth": "INVOKE_HOST_FUNCTION_TRAPPED",
                "fuel": "INVOKE_HOST_FUNCTION_RESOURCE_LIMIT_EXCEEDED"}


def wasm_expected_outcomes(kinds):
    """{(kind, result): count} that phase 12's apply must give."""
    return collections.Counter((k, WASM_RESULTS[k]) for k in kinds
                               if k in WASM_RESULTS)


class NativeBatchVerifier:
    """verify_tuples on the host: the native library, one signature at a
    time, no cache."""

    def verify_tuples(self, items):
        from stellar_core_tpu_torch.crypto.keys import verify_sig_uncached
        return [verify_sig_uncached(p, s, m) for p, s, m in items]


def soroban_outcomes(run, wl):
    """A run's apply by kind: {(kind, result): count}, the result being
    the InvokeHostFunction result code of the one operation, or the
    transaction's code where there is none; and the applied transactions
    that charged no fee or left their source's sequence number below
    their own."""
    from stellar_core_tpu_torch.tx.frame import make_frame
    from stellar_core_tpu_torch.xdr.ledger_entries import LedgerKey
    from stellar_core_tpu_torch.xdr.results import (OperationResultCode,
                                                    TransactionResult)
    from stellar_core_tpu_torch.xdr.transaction import TransactionEnvelope
    frames = {}
    for env, kind in zip(wl["envelopes"], wl["kinds"]):
        f = make_frame(TransactionEnvelope.from_bytes(env), wl["network_id"])
        frames[f.full_hash()] = (f, kind)
    out, unpaid = collections.Counter(), collections.Counter()
    root = run["root"]
    for h, raw in zip(run["order"], run["results"]):
        frame, kind = frames[h]
        res = TransactionResult.from_bytes(raw)
        ops = res.result.value if isinstance(res.result.value, list) else []
        if ops and ops[0].disc == OperationResultCode.opINNER:
            code = ops[0].value.value.disc.name
        else:
            code = res.result.disc.name
        out[(kind, code)] += 1
        src = root._lookup(LedgerKey.account(frame.source_id).to_bytes())
        if res.feeCharged <= 0 or src.data.value.seqNum < frame.seq_num:
            unpaid[kind] += 1
    return out, unpaid


def nonce_entries(root):
    """The nonce entries (CONTRACT_DATA keyed by a nonce) in `root`, and
    how many of them have a TTL entry."""
    from stellar_core_tpu_torch.crypto.sha import sha256
    from stellar_core_tpu_torch.xdr.contract import SCValType
    from stellar_core_tpu_torch.xdr.ledger_entries import (LedgerEntryType,
                                                           LedgerKey)
    nonces = [kb for kb, e in root._entries.items()
              if e.data.disc == LedgerEntryType.CONTRACT_DATA
              and e.data.value.key.disc == SCValType.SCV_LEDGER_KEY_NONCE]
    ttls = sum(LedgerKey.ttl(sha256(kb)).to_bytes() in root._entries
               for kb in nonces)
    return len(nonces), ttls


def contract_runs(card, wl):
    """Runs A and B of a contract phase (11, 12) on the workload `wl`,
    every default invariant on. Run A: validation and trim through
    `_LazyBatchPrevalidator(BackendSupervisor(CudaBatchVerifier()))`,
    then catchup's apply-time batch over the kept transactions (envelope
    and auth-entry tuples, one dispatch) written through to the verify
    cache, then the apply. Run B: the same steps with the native library
    as the batch verifier. The launch counters are set to 0 just before
    run A and read just after; the oracle verdicts come from worker
    processes meanwhile. Returns both runs with their walls, A's
    recorded batches and launches, the kept frames and their kinds, and
    the problems every contract phase checks: A == B on verdicts, trim,
    results, contract events and return values, the apply-time batch
    and the cache's counts during the apply and ledger hash; each batch
    holds exactly its
    collect_signature_tuples pairs, equals the oracle and is false
    exactly on the flipped envelopes and the flipped auth signatures;
    prep msg32 2 + ladder 2 and B launching nothing; no call in the
    second validation; only the flipped dropped (txBAD_AUTH); every
    applied transaction charged its fee and used its sequence number;
    the supervisor CLOSED with 0 failures and 0 skips."""
    from types import SimpleNamespace

    from stellar_core_tpu_torch.crypto import ed25519_ref as ref
    from stellar_core_tpu_torch.ops.backend_supervisor import (
        CLOSED, BackendSupervisor)
    from stellar_core_tpu_torch.ops.verifier import CudaBatchVerifier
    from stellar_core_tpu_torch.tx.frame import make_frame
    from stellar_core_tpu_torch.tx.signature_checker import \
        collect_signature_tuples
    from stellar_core_tpu_torch.xdr.results import TransactionResultCode
    from stellar_core_tpu_torch.xdr.transaction import TransactionEnvelope

    nid = wl["network_id"]
    frames = [make_frame(TransactionEnvelope.from_bytes(b), nid)
              for b in wl["envelopes"]]
    kind_of = {f.full_hash(): k for f, k in zip(frames, wl["kinds"])}
    paired = collect_signature_tuples(frames)
    uniq = sorted(set(collect_signature_tuples(frames, nid)))
    pool = multiprocessing.get_context("spawn").Pool(
        max(1, min(7, (os.cpu_count() or 2) - 1)))
    try:
        oracle = pool.starmap_async(ref.verify, uniq, chunksize=64)
        sup = BackendSupervisor(CudaBatchVerifier())
        rec = RecordingVerifier(sup)
        zero_launches()
        t0 = time.perf_counter()
        a = txset_run(wl, rec, apply_batch=rec, invariants=True,
                      events=True)
        a_s = time.perf_counter() - t0
        launches = launch_counts()
        zero_launches()
        native = RecordingVerifier(NativeBatchVerifier())
        t0 = time.perf_counter()
        b = txset_run(wl, native, apply_batch=native, invariants=True,
                      events=True)
        b_s = time.perf_counter() - t0
        b_launches = launch_counts()
        want = dict(zip(uniq, oracle.get(timeout=900)))
    finally:
        pool.terminate()
        pool.join()
    st = sup.status()
    sup.shutdown()

    problems = []
    for key in ("contents_hash", "verdict", "kept", "dropped", "codes",
                "order", "results", "applied_ok", "apply_verdicts",
                "apply_cache", "ledger_hash", "events"):
        if a[key] != b[key]:
            problems.append(f"run A and run B differ in {key}")
    kept = [f for f in frames if f.full_hash() in set(a["kept"])]
    by_kind = collections.defaultdict(list)
    for f in frames:
        by_kind[kind_of[f.full_hash()]].append(f)
    bad_envelope = collect_signature_tuples(by_kind["flipped"])
    bad_auth = [t for f in by_kind["bad_auth"]
                for t in collect_signature_tuples([f], nid)
                if t not in collect_signature_tuples([f])]
    expect = (("validation", paired, bad_envelope),
              ("apply", collect_signature_tuples(kept, nid), bad_auth))
    if len(rec.calls) != 2:
        problems.append(f"{len(rec.calls)} verify_tuples calls, not 2")
    else:
        for (tag, pairs, false), (items, got, _) in zip(expect, rec.calls):
            if sorted(items) != sorted(pairs):
                problems.append(f"the {tag} batch holds {len(items)} tuples, "
                                f"not the {len(pairs)} collect_signature_"
                                "tuples pairs")
            off = sum(g != want[t] for g, t in zip(got, items))
            if off:
                problems.append(f"{off} {tag} verdicts differ from the "
                                "oracle")
            if sorted(t for t, g in zip(items, got) if not g) != \
                    sorted(false):
                problems.append(f"the {tag} batch's false verdicts are not "
                                f"exactly its {len(false)} bad signatures")
    if launches != {"msg32": 2, "k": 0, "ladder": 2}:
        problems.append(f"run A launched {launches}, not prep msg32 2 + "
                        "ladder 2")
    if any(b_launches.values()):
        problems.append(f"run B launched {b_launches}")
    if a["again_calls"]:
        problems.append(f"the second validation made {a['again_calls']} "
                        "verify_tuples calls")
    problems += dropped_problems(a, kind_of, {
        "flipped": TransactionResultCode.txBAD_AUTH})
    outcomes, unpaid = soroban_outcomes(a, wl)
    if unpaid:
        problems.append(f"transactions that charged no fee or kept their "
                        f"sequence number: {dict(unpaid)}")
    if st["state"] != CLOSED or any(st["failures"].values()) or \
            st["skips"] or st["transitions"]:
        problems.append(f"supervisor: {st['state']}, failures "
                        f"{st['failures']}, skips {st['skips']}, "
                        f"transitions {st['transitions']}")
    return SimpleNamespace(
        a=a, b=b, a_s=a_s, b_s=b_s, rec=rec, launches=launches, kept=kept,
        counts=collections.Counter(kind_of[f.full_hash()] for f in kept),
        outcomes=outcomes, problems=problems)


def contract_walls(tag, r, card):
    """Print the walls of runs A and B of a contract phase."""
    a, b = r.a, r.b
    walls = [c[2] for c in r.rec.calls]
    print(f"{tag}: walls A (card) / B (host): validation "
          f"{a['validate_s'] * 1e3:.1f} / {b['validate_s'] * 1e3:.1f} ms, "
          f"trim {a['trim_s'] * 1e3:.1f} / {b['trim_s'] * 1e3:.1f} ms, "
          f"apply-time batch with its collect and write-through "
          f"{a['apply_batch_s'] * 1e3:.1f} / {b['apply_batch_s'] * 1e3:.1f} "
          f"ms, apply {a['apply_s'] * 1e3:.1f} / {b['apply_s'] * 1e3:.1f} "
          f"ms, run {r.a_s:.3f} / {r.b_s:.3f} s; the card's dispatches are "
          f"{sum(walls) / r.a_s:.5f} of run A [{card}]", flush=True)


def soroban_phase(card, n=SOROBAN_N):
    """Phase 11: contract auth-entry signatures batched on the card
    (BASELINE.json config #4) at n transactions of soroban_workload,
    runs A and B of `contract_runs` with their checks, and besides: the
    holders' XLM equal in A and B, every auth verify of the host's a
    verify-cache hit (0 native verifies), sac_addr, sac_source and scvm
    SUCCESS, bad_auth and expired TRAPPED, one nonce entry and one TTL
    per verified address entry. Returns the launches of run A by
    kernel."""
    from stellar_core_tpu_torch.xdr.ledger_entries import LedgerKey
    from stellar_core_tpu_torch.xdr.types import PublicKey

    t0 = time.perf_counter()
    wl = soroban_workload(n)
    build_s = time.perf_counter() - t0
    r = contract_runs(card, wl)
    a, counts, problems = r.a, r.counts, r.problems

    def balances(run):
        return [run["root"]._lookup(LedgerKey.account(
            PublicKey.from_bytes(h)).to_bytes()).data.value.balance
            for h in wl["holders"]]

    if balances(a) != balances(r.b):
        problems.append("run A and run B differ in the holders' XLM")
    verified = counts["sac_addr"] + counts["scvm"] + counts["bad_auth"]
    if a["apply_cache"] != (verified, 0) or a["apply_pv"][1]:
        problems.append(f"the apply's verify cache (hits, misses) was "
                        f"{a['apply_cache']}, not ({verified}, 0), and its "
                        f"table missed {a['apply_pv'][1]} times")
    code_of = {"sac_addr": "INVOKE_HOST_FUNCTION_SUCCESS",
               "sac_source": "INVOKE_HOST_FUNCTION_SUCCESS",
               "scvm": "INVOKE_HOST_FUNCTION_SUCCESS",
               "bad_auth": "INVOKE_HOST_FUNCTION_TRAPPED",
               "expired": "INVOKE_HOST_FUNCTION_TRAPPED"}
    wrong = {k: c for k, c in r.outcomes.items()
             if code_of.get(k[0]) != k[1]}
    if wrong:
        problems.append(f"results off their kind: {wrong}")
    nonces = nonce_entries(a["root"])
    if nonces != (counts["sac_addr"] + counts["scvm"],) * 2:
        problems.append(f"{nonces[0]} nonce entries ({nonces[1]} with a "
                        f"TTL) for {counts['sac_addr'] + counts['scvm']} "
                        "verified address entries")
    if problems:
        raise SystemExit("soroban: " + "; ".join(problems))
    calls = r.rec.calls
    kinds = collections.Counter(wl["kinds"])
    print(f"soroban: {n} InvokeHostFunction transactions "
          f"({len(a['kept'])} valid) over {len(wl['entries'])} entries, "
          f"chosen mix {dict(kinds)}; built in {build_s:.3f} s; dispatches "
          f"{len(calls[0][0])} signatures (validation) "
          f"{calls[0][2] * 1e3:.2f} ms and {len(calls[1][0])} (apply, "
          f"{len(calls[1][0]) - len(r.kept)} auth entries) "
          f"{calls[1][2] * 1e3:.2f} ms, prep msg32 2 + ladder 2 [{card}]",
          flush=True)
    contract_walls("soroban", r, card)
    print("soroban: results by kind "
          + ", ".join(f"{k} {c} {m}"
                      for (k, c), m in sorted(r.outcomes.items()))
          + f"; dropped {len(a['dropped'])} (flipped); verify cache during "
          f"the apply: {a['apply_cache'][0]} hits, {a['apply_cache'][1]} "
          f"misses (0 native verifies by the host); {nonces[0]} nonce "
          f"entries with {nonces[1]} TTLs; invariants on; runs A and B "
          f"equal on verdicts, trim, results, events, the holders' XLM "
          f"and ledger hash {a['ledger_hash'].hex()[:16]}; both batches "
          f"equal the oracle; supervisor CLOSED, 0 failures, 0 skips "
          f"[{card}]",
          flush=True)
    return r.launches


def wasm_phase(card, n=WASM_N):
    """Phase 12: wasm contracts on the card's txset path (BASELINE.json
    config #4 with wasm contracts) at n transactions of wasm_workload,
    runs A and B of `contract_runs` with their checks, and besides: the
    contract events and return values equal in A and B; results by kind
    as WASM_RESULTS says; during A's apply the verify cache hit once per
    address-credential entry require_auth reached (env_auth, bad_auth
    and fuel: the wasm meter runs out after the verify) and missed
    exactly once per contract-level verify (sig_ok + sig_bad, which the
    host verifies natively: nothing batches them); one nonce entry and
    one TTL per env_auth; the load generator's counter read equal to its
    wasm_counter calls; the module cache holding exactly the three
    contracts. Returns the launches of run A by kernel."""
    from stellar_core_tpu_torch.soroban.wasm_host import _MODULE_CACHE

    t0 = time.perf_counter()
    wl = wasm_workload(n)
    build_s = time.perf_counter() - t0
    r = contract_runs(card, wl)
    a, counts, problems = r.a, r.counts, r.problems
    want = wasm_expected_outcomes(wl["kinds"])
    if r.outcomes != want:
        problems.append(f"results by kind {dict(r.outcomes)}, not "
                        f"{dict(want)}")
    reached = counts["env_auth"] + counts["bad_auth"] + counts["fuel"]
    native = counts["sig_ok"] + counts["sig_bad"]
    if a["apply_cache"] != (reached, native) or a["apply_pv"][1]:
        problems.append(f"the apply's verify cache (hits, misses) was "
                        f"{a['apply_cache']}, not ({reached}, {native}), "
                        f"and its table missed {a['apply_pv'][1]} times")
    nonces = nonce_entries(a["root"])
    if nonces != (counts["env_auth"],) * 2:
        problems.append(f"{nonces[0]} nonce entries ({nonces[1]} with a "
                        f"TTL) for {counts['env_auth']} env_auth calls")
    count = a["root"]._lookup(wl["count_key"])
    if count is None or count.data.value.val.value != counts["wasm_counter"]:
        problems.append(f"the load generator's counter reads "
                        f"{count and count.data.value.val.value}, not "
                        f"{counts['wasm_counter']}")
    events = sum(bool(ev) for ev, _ in a["events"])
    if events != counts["env_auth"]:
        problems.append(f"{events} transactions emitted contract events, "
                        f"not the {counts['env_auth']} env_auth")
    if sorted(_MODULE_CACHE) != sorted(wl["codes"]):
        problems.append(f"the module cache holds {len(_MODULE_CACHE)} "
                        "modules, not the three contracts")
    if problems:
        raise SystemExit("wasm: " + "; ".join(problems))
    calls = r.rec.calls
    kinds = collections.Counter(wl["kinds"])
    print(f"wasm: {n} InvokeHostFunction transactions on wasm contracts "
          f"({len(a['kept'])} valid) over {len(wl['entries'])} entries, "
          f"chosen mix {dict(kinds)}; built in {build_s:.3f} s; dispatches "
          f"{len(calls[0][0])} signatures (validation) "
          f"{calls[0][2] * 1e3:.2f} ms and {len(calls[1][0])} (apply, "
          f"{len(calls[1][0]) - len(r.kept)} auth entries) "
          f"{calls[1][2] * 1e3:.2f} ms, prep msg32 2 + ladder 2 [{card}]",
          flush=True)
    contract_walls("wasm", r, card)
    print("wasm: results by kind "
          + ", ".join(f"{k} {c} {m}"
                      for (k, c), m in sorted(r.outcomes.items()))
          + f"; dropped {len(a['dropped'])} (flipped); verify cache during "
          f"the apply: {a['apply_cache'][0]} hits (auth entries that "
          f"require_auth reached), {a['apply_cache'][1]} misses (the "
          f"host's native verifies of contract-level signatures); "
          f"{nonces[0]} nonce entries with {nonces[1]} TTLs; the counter "
          f"reads {counts['wasm_counter']}; {events} transactions with "
          f"events; module cache {len(_MODULE_CACHE)} contracts "
          f"({', '.join(h.hex()[:8] for h in sorted(_MODULE_CACHE))}); "
          f"invariants on; runs A and B "
          f"equal on verdicts, trim, results, events and ledger hash "
          f"{a['ledger_hash'].hex()[:16]}; both batches equal the oracle; "
          f"supervisor CLOSED, 0 failures, 0 skips [{card}]", flush=True)
    return r.launches


def close_modules():
    """The port's modules a close run and a catchup run drive, by the
    short names tests/torch_tx_parity.py's `Pkg` gives them."""
    import importlib
    from types import SimpleNamespace
    return SimpleNamespace(**{k: importlib.import_module(
        f"stellar_core_tpu_torch.{m}") for k, m in (
        ("keys", "crypto.keys"), ("frame", "tx.frame"),
        ("transaction", "xdr.transaction"), ("ledger", "xdr.ledger"),
        ("tx_set", "herder.tx_set"), ("perf", "util.perf"),
        ("ledger_manager", "ledger.ledger_manager"),
        ("database", "db.database"), ("bucket_manager", "bucket.manager"),
        ("persistent_state", "main.persistent_state"),
        ("timer", "util.timer"), ("tracing", "util.tracing"),
        ("history", "history"), ("process", "process"), ("work", "work"),
        ("catchup", "catchup"), ("gcpolicy", "util.gcpolicy"),
        ("herder", "herder.herder"), ("upgrades", "herder.upgrades"),
        ("checker", "tx.signature_checker"), ("metrics", "util.metrics"),
        ("scp_xdr", "xdr.scp"), ("types", "xdr.types"),
        ("pending_envelopes", "herder.pending_envelopes"),
        ("scp_driver", "herder.scp_driver"),
        ("application", "main.application"), ("config", "main.config"))})


def close_workload(accounts=CLOSE_ACCOUNTS, txs=CLOSE_TXS,
                   ledgers=CLOSE_LEDGERS, seed=CLOSE_SEED, quiet=0,
                   quiet_txs=0, control=True, flooded=False):
    """Phase 13's closes as XDR bytes, built with the port only, for a
    node whose genesis is at protocol 21 on the standalone network, or,
    `flooded`, for validators that admit every transaction by flood on
    core's network (CORE_PASSPHRASE):
    - a close with no transaction that votes LEDGER_UPGRADE_MAX_TX_SET_SIZE
      = CLOSE_MAX_TX_SET (genesis admits 100 operations per set);
    - closes that create `accounts` accounts with CreateAccount ops, 100
      per transaction from the master, as the load generator's
      generate_accounts does (its keys and starting balance), at most
      CLOSE_MAX_TX_SET operations per close;
    - `quiet` closes of `quiet_txs` one-Payment transactions each (tag
      "quiet"), source 2j paying 2j + 1 over a fresh seeded permutation;
    - `ledgers` measured closes of `txs` one-Payment transactions each
      (native, CLOSE_AMOUNT stroops, fee 100, as generate_payments makes
      them), a chosen mix placed by a seeded permutation: a fresh seeded
      permutation of the accounts pairs source 2j with destination
      2j + 1; CLOSE_MIX's "conflict" transactions pay the destination of
      another ("pair") transaction of the ledger instead of their own,
      which puts one of the two in a second stage, and its "flipped"
      ones carry one flipped signature byte (txBAD_AUTH at apply, the fee
      charged; `flooded`, where flood admission rejects them, they leave
      their source's sequence number where it was, so its next
      transaction takes the same one);
    - with `control`, one close in the load generator's PAY chain,
      order[i] paying order[i + 1] over a seeded permutation: one
      conflict component, so every stage has width 1 and nothing is
      prewarmed.
    Needs accounts >= 2 * max(txs, quiet_txs)."""
    from stellar_core_tpu_torch.crypto.keys import SecretKey
    from stellar_core_tpu_torch.crypto.sha import sha256
    from stellar_core_tpu_torch.tx.frame import make_frame
    from stellar_core_tpu_torch.tx.tx_utils import starting_sequence_number
    from stellar_core_tpu_torch.xdr.ledger import (LedgerUpgrade,
                                                   LedgerUpgradeType)
    from stellar_core_tpu_torch.xdr.ledger_entries import Asset, AssetType
    from stellar_core_tpu_torch.xdr.transaction import (
        CreateAccountOp, DecoratedSignature, Memo, MemoType, MuxedAccount,
        Operation, OperationType, PaymentOp, Preconditions,
        PreconditionType, Transaction, TransactionEnvelope,
        TransactionV1Envelope, _OperationBody, _TxExt)
    from stellar_core_tpu_torch.xdr.types import EnvelopeType, PublicKey

    if accounts < 2 * max(txs, quiet_txs):
        raise ValueError(f"close_workload: {accounts} accounts hold no "
                         f"{max(txs, quiet_txs)} disjoint pairs")
    rng = np.random.default_rng(seed)
    passphrase = CORE_PASSPHRASE if flooded else CLOSE_PASSPHRASE
    network_id = sha256(passphrase.encode())
    master = SecretKey.from_seed(network_id)
    keys = [SecretKey.from_seed(sha256(b"loadgen-%d-%d"
                                       % (i, CLOSE_PEER_PORT)))
            for i in range(accounts)]

    def envelope(sk, seq, ops, flip=False):
        tx = Transaction(
            sourceAccount=MuxedAccount.from_ed25519(sk.public_key().raw),
            fee=100 * len(ops), seqNum=seq,
            cond=Preconditions(PreconditionType.PRECOND_NONE),
            memo=Memo(MemoType.MEMO_NONE), operations=ops, ext=_TxExt(0))
        v1 = TransactionV1Envelope(tx=tx, signatures=[])
        env = TransactionEnvelope(EnvelopeType.ENVELOPE_TYPE_TX, v1)
        sig = bytearray(sk.sign(make_frame(env, network_id).contents_hash()))
        if flip:
            sig[int(rng.integers(64))] ^= 1 << int(rng.integers(8))
        v1.signatures.append(DecoratedSignature(
            hint=sk.public_key().hint(), signature=bytes(sig)))
        return env.to_bytes()

    def pay(i, j):
        seqs[i] += 1
        return seqs[i], [Operation(sourceAccount=None, body=_OperationBody(
            OperationType.PAYMENT, PaymentOp(
                destination=MuxedAccount.from_ed25519(
                    keys[j].public_key().raw),
                asset=Asset(AssetType.ASSET_TYPE_NATIVE),
                amount=CLOSE_AMOUNT)))]

    up = LedgerUpgrade(LedgerUpgradeType.LEDGER_UPGRADE_MAX_TX_SET_SIZE,
                       CLOSE_MAX_TX_SET)
    closes = [dict(tag="upgrade", envelopes=[], upgrades=[up.to_bytes()])]
    seqs, master_seq, created = {}, starting_sequence_number(1), 0
    while created < accounts:
        envs, ops_in, seq = [], 0, len(closes) + 2
        while created < accounts and \
                ops_in + min(100, accounts - created) <= CLOSE_MAX_TX_SET:
            batch = range(created, min(created + 100, accounts))
            master_seq += 1
            envs.append(envelope(master, master_seq, [Operation(
                sourceAccount=None, body=_OperationBody(
                    OperationType.CREATE_ACCOUNT, CreateAccountOp(
                        destination=PublicKey.ed25519(
                            keys[i].public_key().raw),
                        startingBalance=CLOSE_BALANCE))) for i in batch]))
            for i in batch:
                seqs[i] = starting_sequence_number(seq)
            ops_in += len(batch)
            created += len(batch)
        closes.append(dict(tag="create", envelopes=envs, upgrades=[]))
    for _ in range(quiet):
        perm = [int(x) for x in rng.permutation(accounts)]
        closes.append(dict(tag="quiet", upgrades=[], envelopes=[
            envelope(keys[perm[2 * j]], *pay(perm[2 * j], perm[2 * j + 1]))
            for j in range(quiet_txs)]))
    for _ in range(ledgers):
        perm = [int(x) for x in rng.permutation(accounts)]
        kinds = ["pair"] * txs
        order = rng.permutation(txs)
        at = 0
        for kind, share in CLOSE_MIX:
            k = max(1, round(share * txs))
            for j in order[at:at + k]:
                kinds[j] = kind
            at += k
        pairs = [j for j in range(txs) if kinds[j] == "pair"]
        targets = iter(int(t) for t in rng.choice(
            pairs, size=kinds.count("conflict"), replace=False))
        envs = []
        for j, kind in enumerate(kinds):
            dst = perm[2 * next(targets) + 1] if kind == "conflict" \
                else perm[2 * j + 1]
            envs.append(envelope(keys[perm[2 * j]], *pay(perm[2 * j], dst),
                                 flip=kind == "flipped"))
            if flooded and kind == "flipped":
                seqs[perm[2 * j]] -= 1
        closes.append(dict(tag="measured", envelopes=envs, upgrades=[],
                           kinds=kinds))
    if control:
        chain = [int(x) for x in rng.permutation(accounts)]
        closes.append(dict(tag="control", upgrades=[], envelopes=[
            envelope(keys[chain[i]], *pay(chain[i], chain[i + 1]))
            for i in range(txs)]))
    return {"network_id": network_id, "passphrase": passphrase,
            "closes": closes}


def counted_verify_cache(keys):
    """Make the process verify cache's lookups count exactly from the
    staged apply's worker threads (its counters are plain attribute
    increments); returns the undo."""
    import threading
    cache, lock = keys._verify_cache, threading.Lock()
    probe = type(cache).maybe_get.__get__(cache)

    def maybe_get(key):
        with lock:
            return probe(key)
    cache.maybe_get = maybe_get
    return lambda: vars(cache).pop("maybe_get", None)


def collector_pauses():
    """Time every pass of Python's garbage collector from now on:
    returns the list that collects (generation, seconds) per pass and
    the undo."""
    import gc
    pauses, start = [], []

    def timed(phase, info):
        if phase == "start":
            start.append(time.perf_counter())
        elif start:
            pauses.append((info["generation"],
                           time.perf_counter() - start.pop()))
    gc.callbacks.append(timed)
    return pauses, lambda: gc.callbacks.remove(timed)


def close_node(pkg, directory, passphrase, meta=None):
    """A LedgerManager over a sqlite Database and a BucketManager in
    `directory` (new ones, or those a run left there), with the
    persistent state and network passphrase the Application gives it;
    its own perf zone registry. Installs the package's garbage collector
    policy first, as the Application does when it is built. The install
    is process-wide and happens once per package (each keeps its own
    flag): a process that builds nodes of both packages, as the parity
    tests do, collects and freezes its heap at each package's first
    node. Whoever builds a node here ends its teardown with the
    package's gcpolicy.teardown_collect() (a full pass every eighth
    call), as Application.shutdown does."""
    pkg.gcpolicy.install()
    db = pkg.database.Database(os.path.join(directory, "node.db"))
    db.upgrade_to_current_schema()
    bm = pkg.bucket_manager.BucketManager(os.path.join(directory, "buckets"))
    lm = pkg.ledger_manager.LedgerManager(db=db, bucket_manager=bm,
                                          meta_stream=meta)
    lm.persistent_state = pkg.persistent_state.PersistentState(db)
    lm.network_passphrase = passphrase
    lm.perf = pkg.perf.ZoneRegistry()
    return lm


def close_data(pkg, lm, nid, c, i):
    """The LedgerCloseData of close `i` of a workload (`c`) on top of
    `lm`'s LCL, as the manual close makes it: the envelopes' txset
    through make_tx_set_from_transactions (exits if surge pricing leaves
    one out), a StellarValue with the close's upgrades and a close time
    from the sequence."""
    lcl = lm.get_last_closed_ledger_header()
    frames = [pkg.frame.make_frame(
        pkg.transaction.TransactionEnvelope.from_bytes(b), nid)
        for b in c["envelopes"]]
    frame, _, excluded = pkg.tx_set.make_tx_set_from_transactions(
        frames, lcl, nid)
    if excluded:
        raise SystemExit(f"close {i}: surge pricing left out "
                         f"{len(excluded)} transactions")
    value = pkg.ledger.StellarValue(
        txSetHash=frame.get_contents_hash(),
        closeTime=1_700_000_000 + lcl.ledgerSeq,
        upgrades=list(c["upgrades"]))
    return pkg.ledger_manager.LedgerCloseData(lcl.ledgerSeq + 1, frame,
                                              value)


def close_run(wl, directory, pkg=None, verify_service=None, staged=True,
              on_close=None):
    """Genesis at protocol 21 and every close of `wl` on `close_node` in
    `directory`, each close from its envelope bytes through
    make_tx_set_from_transactions and LedgerManager.close_ledger, then
    join_completion, as the manual close does. `staged` sets the node's
    staged apply (APPLY_PARALLEL workers from APPLY_PARALLEL_MIN_TXS
    transactions); `verify_service` is the manager's, whose per-stage
    prewarm it serves. Per close it records the header, its hash, the
    result pairs and the LedgerCloseMeta as bytes, the bucket levels'
    hashes, the stages' widths, the verify cache's (hits, misses) during
    the close, the prewarm's wall, the close's wall, its
    `ledger.close.*` zones and the garbage collector's passes during it
    (their seconds, and how many were full, generation 2); then every
    row of CLOSE_TABLES, sorted, and the
    bucket files' names with the sha256 of their bytes. `on_close(i,
    tag)` runs just before close i. `pkg` holds the modules of the
    package to run, by `close_modules()`'s names (the port's by
    default). The node's teardown ends with the package's
    gcpolicy.teardown_collect(), as Application.shutdown does."""
    pkg = pkg or close_modules()
    metas = []
    lm = close_node(pkg, directory, wl["passphrase"], metas.append)
    nid = wl["network_id"]
    if staged:
        lm.apply_parallel = APPLY_PARALLEL
        lm.apply_parallel_min_txs = APPLY_PARALLEL_MIN_TXS
    lm.verify_service = verify_service
    prewarm = []
    inner = lm._prewarm_stage_verify

    def timed_prewarm(stage_txs):
        t0 = time.perf_counter()
        inner(stage_txs)
        prewarm.append(time.perf_counter() - t0)
    lm._prewarm_stage_verify = timed_prewarm
    undo = counted_verify_cache(pkg.keys)
    pauses, undo_gc = collector_pauses()
    try:
        lm.start_new_ledger(nid, protocol_version=21)
        genesis = lm.get_last_closed_ledger_hash()
        out = []
        for i, c in enumerate(wl["closes"]):
            if on_close is not None:
                on_close(i, c["tag"])
            lcd = close_data(pkg, lm, nid, c, i)
            zones = lm.perf.report()
            prewarm.clear()
            pauses.clear()
            pkg.keys.flush_verify_cache_counts()
            t0 = time.perf_counter()
            lm.close_ledger(lcd)
            lm.join_completion()
            wall = time.perf_counter() - t0
            cache = pkg.keys.flush_verify_cache_counts()
            after = lm.perf.report()
            header = lm.get_last_closed_ledger_header()
            meta = metas[-1]
            out.append(dict(
                tag=c["tag"], header=header.to_bytes(),
                hash=lm.get_last_closed_ledger_hash(),
                results=[t.result.to_bytes()
                         for t in meta.value.txProcessing],
                meta=meta.to_bytes(),
                buckets=[(lvl.curr.hash, lvl.snap.hash) for lvl in
                         lm.bucket_manager.bucket_list.levels],
                widths=list(lm.last_stage_widths), cache=cache,
                prewarm_s=sum(prewarm), wall_s=wall,
                gc_s=sum(t for _, t in pauses),
                gc_full=sum(g == 2 for g, _ in pauses),
                zones_ms={z: after.get(f"ledger.close.{z}", {}).get(
                    "total_ms", 0.0) - zones.get(f"ledger.close.{z}",
                                                 {}).get("total_ms", 0.0)
                    for z in CLOSE_ZONES}))
        rows = {t: sorted(lm.db.execute(f"SELECT * FROM {t}").fetchall())
                for t in CLOSE_TABLES}
    finally:
        undo_gc()
        undo()
        lm.join_completion(reraise=False)
        lm.bucket_manager.shutdown()
        lm.db.close()
        pkg.gcpolicy.teardown_collect()
    bdir = os.path.join(directory, "buckets")
    files = {}
    for f in sorted(os.listdir(bdir)):
        with open(os.path.join(bdir, f), "rb") as fh:
            files[f] = hashlib.sha256(fh.read()).hexdigest()
    return {"genesis": genesis, "ledgers": out, "rows": rows,
            "files": files, "lcl": out[-1]["hash"] if out else genesis}


def close_reload(directory, passphrase, pkg=None):
    """A fresh LedgerManager over the database and bucket directory a
    close run left in `directory`: (load_last_known_ledger(), its LCL
    hash, its LCL sequence). Its teardown ends as close_run's does."""
    pkg = pkg or close_modules()
    lm = close_node(pkg, directory, passphrase)
    try:
        loaded = lm.load_last_known_ledger()
        return (loaded, lm.get_last_closed_ledger_hash(),
                lm.get_last_closed_ledger_num())
    finally:
        lm.bucket_manager.shutdown()
        lm.db.close()
        pkg.gcpolicy.teardown_collect()


def close_expected(widths, max_batch, min_batch):
    """What the prewarm of one close must do, from its stages' widths:
    one tuple per transaction of every stage of 2 or more, each stage
    flushed as submit_many does at `max_batch` (floor(w / max_batch)
    `batch_full` flushes, then one `demand` flush of the remainder when
    the first future is awaited); a flush of at least `min_batch`
    tuples is a device dispatch, a smaller one the verifier's native
    bypass; every transaction of a width-1 stage verifies at apply
    without a prewarm (a cache miss), every prewarmed tuple is a hit."""
    staged = [w for w in widths if w > 1]
    flushes = [max_batch] * sum(w // max_batch for w in staged) + \
        [w % max_batch for w in staged if w % max_batch]
    return {"tuples": sum(staged),
            "batch_full": sum(w // max_batch for w in staged),
            "demand": sum(1 for w in staged if w % max_batch),
            "device": sum(n >= min_batch for n in flushes),
            "bypass": sum(n < min_batch for n in flushes),
            "cache": (sum(staged), len(widths) - len(staged))}

def close_phase(card, accounts=CLOSE_ACCOUNTS, txs=CLOSE_TXS,
                ledgers=CLOSE_LEDGERS):
    """Phase 13: persistence and ledger close (BASELINE.json config #1,
    standalone) with the staged apply's per-stage signature prewarm on
    the card. `close_workload(accounts, txs, ledgers)` runs twice from
    the same bytes, each on a node of its own in a fresh directory: run
    A with the node's wiring (APPLY_PARALLEL workers from
    APPLY_PARALLEL_MIN_TXS transactions, the manager's verify service
    VerifyService(BackendSupervisor(CudaBatchVerifier())) at the node's
    LIVE defaults, as phase 7 builds it), run B the same with no verify
    service (the native path). The verify cache is cleared before each
    run and the launch counters are set to 0 just before run A and read
    just after; the oracle verdicts of the measured closes' signatures
    come from worker processes before the runs, so that no worker
    shares the host's cores with them. Fails unless A equals B on
    every close's header, hash, result pairs, LedgerCloseMeta and
    bucket levels and on the final rows and bucket files; a fresh
    LedgerManager over A's database and bucket directory loads A's LCL;
    every prewarm verdict equals the oracle; each close's stages,
    submits, flushes by reason, device dispatches and bypasses are
    those `close_expected` gives from its stage widths; prep msg32
    launches equal ladder launches equal the supervisor's device
    dispatches, more than 0, with no k launch; the supervisor ends
    CLOSED with 0 failures and 0 skips and the service with 0
    fallbacks; during each close of A the verify cache misses once per
    transaction of a width-1 stage and hits once per prewarmed tuple
    more than in B's close; B misses once per transaction; the control
    close submits nothing and launches nothing; the flipped transactions
    end txBAD_AUTH and the rest txSUCCESS. Returns the launches of run A
    by kernel."""
    from stellar_core_tpu_torch.crypto import ed25519_ref as ref
    from stellar_core_tpu_torch.crypto.keys import clear_verify_cache
    from stellar_core_tpu_torch.ops.backend_supervisor import (
        CLOSED, BackendSupervisor)
    from stellar_core_tpu_torch.ops.verifier import CudaBatchVerifier
    from stellar_core_tpu_torch.ops.verify_service import VerifyService
    from stellar_core_tpu_torch.tx.frame import make_frame
    from stellar_core_tpu_torch.tx.signature_checker import \
        collect_signature_tuples
    from stellar_core_tpu_torch.util.metrics import MetricsRegistry
    from stellar_core_tpu_torch.util.perf import ZoneRegistry
    from stellar_core_tpu_torch.util.timer import ClockMode, VirtualClock
    from stellar_core_tpu_torch.xdr.results import (TransactionResultCode,
                                                    TransactionResultPair)
    from stellar_core_tpu_torch.xdr.transaction import TransactionEnvelope

    t0 = time.perf_counter()
    wl = close_workload(accounts, txs, ledgers)
    build_s = time.perf_counter() - t0
    nid = wl["network_id"]
    tuples = [collect_signature_tuples([make_frame(
        TransactionEnvelope.from_bytes(b), nid) for b in c["envelopes"]])
        for c in wl["closes"]]
    measured = sorted({t for c, ts in zip(wl["closes"], tuples)
                       if c["tag"] == "measured" for t in ts})
    reg, perf = MetricsRegistry(), ZoneRegistry()
    clock = VirtualClock(ClockMode.REAL_TIME)
    sup = BackendSupervisor(
        CudaBatchVerifier(perf=perf, metrics=reg,
                          device_min_batch=LIVE["device_min_batch"]),
        clock=clock, metrics=reg, perf=perf,
        dispatch_deadline_ms=LIVE["dispatch_deadline_ms"],
        canary_batch=LIVE["canary_batch"])
    rec = RecordingVerifier(sup)
    svc = VerifyService(rec, clock=clock, metrics=reg, perf=perf,
                        max_batch=LIVE["max_batch"],
                        deadline_ms=LIVE["deadline_ms"])
    snaps = []

    def snapshot(*_):
        st = svc.stats()
        snaps.append(dict(
            submitted=st["submitted"], reasons=dict(st["flush_reasons"]),
            device=reg.to_json()["crypto.verify.dispatch.batch"]["count"],
            native=perf.report().get("crypto.batchVerify.native",
                                     {"count": 0})["count"],
            calls=len(rec.calls), launches=launch_counts()))

    work = tempfile.mkdtemp(prefix="chip-smoke-close-")
    pool = multiprocessing.get_context("spawn").Pool(
        max(1, min(7, (os.cpu_count() or 2) - 1)))
    try:
        t0 = time.perf_counter()
        want = dict(zip(measured, pool.starmap(ref.verify, measured,
                                               chunksize=64)))
        oracle_s = time.perf_counter() - t0
        pool.close()
        clear_verify_cache()
        zero_launches()
        t0 = time.perf_counter()
        a = close_run(wl, os.path.join(work, "a"), verify_service=svc,
                      on_close=snapshot)
        a_s = time.perf_counter() - t0
        snapshot()
        launches = launch_counts()
        clear_verify_cache()
        zero_launches()
        t0 = time.perf_counter()
        b = close_run(wl, os.path.join(work, "b"))
        b_s = time.perf_counter() - t0
        b_launches = launch_counts()
        reload = close_reload(os.path.join(work, "a"), wl["passphrase"])
    finally:
        pool.terminate()
        pool.join()
        shutil.rmtree(work, ignore_errors=True)
    st = sup.status()
    stats = svc.stats()
    sup.shutdown()

    problems = []
    for i, (la, lb) in enumerate(zip(a["ledgers"], b["ledgers"])):
        for key in ("header", "hash", "results", "meta", "buckets"):
            if la[key] != lb[key]:
                problems.append(f"close {i}: runs A and B differ in {key}")
    for key in ("rows", "files", "lcl"):
        if a[key] != b[key]:
            problems.append(f"runs A and B differ in {key}")
    if reload[:2] != (True, a["lcl"]):
        problems.append(f"a fresh LedgerManager over run A's files loaded "
                        f"{reload[0]} at {reload[1].hex()[:16]}, not "
                        f"{a['lcl'].hex()[:16]}")
    off = sum(g != want.get(t) for items, got, _ in rec.calls
              for t, g in zip(items, got))
    if off:
        problems.append(f"{off} prewarm verdicts differ from the oracle")
    device = snaps[-1]["device"]
    if not device or launches != {"msg32": device, "k": 0,
                                  "ladder": device}:
        problems.append(f"run A launched {launches} for {device} device "
                        "dispatches")
    if any(b_launches.values()):
        problems.append(f"run B launched {b_launches}")
    if st["state"] != CLOSED or any(st["failures"].values()) or \
            st["skips"] or st["transitions"] or stats["fallbacks"]:
        problems.append(f"supervisor: {st['state']}, failures "
                        f"{st['failures']}, skips {st['skips']}, "
                        f"transitions {st['transitions']}; service "
                        f"fallbacks {stats['fallbacks']}")
    if st["dispatches"] != device + snaps[-1]["native"]:
        problems.append(f"supervisor dispatches {st['dispatches']} != "
                        f"{device} device + {snaps[-1]['native']} bypassed")
    rows = []
    for i, (c, la, lb) in enumerate(zip(wl["closes"], a["ledgers"],
                                        b["ledgers"])):
        s0, s1 = snaps[i], snaps[i + 1]
        exp = close_expected(la["widths"], LIVE["max_batch"],
                             LIVE["device_min_batch"])
        got = dict(tuples=s1["submitted"] - s0["submitted"],
                   batch_full=s1["reasons"]["batch_full"]
                   - s0["reasons"]["batch_full"],
                   demand=s1["reasons"]["demand"] - s0["reasons"]["demand"],
                   device=s1["device"] - s0["device"],
                   bypass=s1["native"] - s0["native"],
                   cache=(la["cache"][0] - lb["cache"][0], la["cache"][1]))
        if got != exp or lb["widths"] != la["widths"] or \
                lb["cache"][1] != len(c["envelopes"]):
            problems.append(f"close {i} ({c['tag']}): prewarm {got} (the "
                            f"cache: A's hits over B's, A's misses), "
                            f"expected {exp} from stages {la['widths'][:4]}"
                            f"...; B's cache {lb['cache']} for "
                            f"{len(c['envelopes'])} transactions")
        flushed = collections.Counter(
            t for items, _, _ in rec.calls[s0["calls"]:s1["calls"]]
            for t in items)
        if flushed - collections.Counter(tuples[i]):
            problems.append(f"close {i}: a prewarm flush holds a tuple "
                            "that is not the close's")
        if c["tag"] == "measured":
            codes = collections.Counter(
                TransactionResultPair.from_bytes(r).result.result.disc
                for r in la["results"])
            flipped = c["kinds"].count("flipped")
            if codes != {TransactionResultCode.txSUCCESS:
                         len(c["envelopes"]) - flipped,
                         TransactionResultCode.txBAD_AUTH: flipped}:
                problems.append(f"close {i}: results {dict(codes)}")
        if c["tag"] == "control" and (got["tuples"] or got["device"] or
                                      s1["launches"] != s0["launches"]):
            problems.append(f"the control close prewarmed {got} and "
                            f"launched {s1['launches']} after "
                            f"{s0['launches']}")
        rows.append((c, la, lb, got))
    if problems:
        raise SystemExit("close: " + "; ".join(problems))

    walls = [w for _, _, w in rec.calls]
    print(f"close: {accounts} accounts, {ledgers} closes of {txs} "
          f"one-Payment transactions (chosen mix {dict(CLOSE_MIX)}, the "
          f"rest disjoint pairs) and one PAY-chain control close; built in "
          f"{build_s:.3f} s; the oracle of {len(measured)} signatures in "
          f"{oracle_s:.3f} s before the runs; run A (staged apply, prewarm "
          f"on the card) "
          f"{a_s:.3f} s, run B (staged apply, no verify service) {b_s:.3f} "
          f"s [{card}]", flush=True)
    for i, (c, la, lb, got) in enumerate(rows):
        widths = collections.Counter(la["widths"])
        print(f"  close {i + 2} {c['tag']}: {len(c['envelopes'])} txs, "
              f"stages {len(la['widths'])} widths "
              f"{dict(sorted(widths.items(), reverse=True))}; prewarm "
              f"{got['tuples']} tuples, flushes batch_full "
              f"{got['batch_full']} demand {got['demand']}, device "
              f"{got['device']} bypass {got['bypass']}; cache (hits, "
              f"misses) A {la['cache']} B {lb['cache']}; wall A "
              f"{la['wall_s'] * 1e3:.1f} ms (prewarm "
              f"{la['prewarm_s'] * 1e3:.2f} ms) B {lb['wall_s'] * 1e3:.1f} "
              f"ms (prewarm {lb['prewarm_s'] * 1e3:.2f} ms); collector A "
              f"{la['gc_s'] * 1e3:.1f} ms ({la['gc_full']} full) B "
              f"{lb['gc_s'] * 1e3:.1f} ms ({lb['gc_full']} full); zones A "
              + " ".join(f"{z}={v:.1f}" for z, v in la["zones_ms"].items())
              + " B " + " ".join(f"{z}={v:.1f}"
                                 for z, v in lb["zones_ms"].items()),
              flush=True)
    print(f"close: {len(walls)} prewarm flushes, dispatch to collected "
          f"min {min(walls) * 1e3:.2f} / median "
          f"{statistics.median(walls) * 1e3:.2f} / max "
          f"{max(walls) * 1e3:.2f} ms; run B made none; launches prep "
          f"msg32 {launches['msg32']} = ladder {launches['ladder']} = "
          f"device dispatches {device}; supervisor dispatches "
          f"{st['dispatches']}, failures 0, skips 0, CLOSED; service "
          f"submits {stats['submitted']}, flushes by reason "
          f"{stats['flush_reasons']}, fallbacks 0; runs A and B equal on "
          f"every header, result, meta and bucket level, LCL "
          f"{a['lcl'].hex()[:16]} at ledger {reload[2]}, the final rows "
          f"and {len(a['files'])} bucket files; reloaded from run A's "
          f"files; every prewarm verdict equals the oracle [{card}]",
          flush=True)
    return launches


# the timers a node of this script leaves manual, as the JAX package's
# get_test_config and Simulation._make_config do: on a virtual clock the
# telemetry sampler and the adaptive controller would fire every virtual
# second of a run (the controller re-tunes the verify knobs) and the
# maintainer's hourly cron would let an idle crank leap an hour
MANUAL_TIMERS = dict(TELEMETRY_SAMPLE_PERIOD=0.0, CONTROLLER_TICK_PERIOD=0.0,
                     AUTOMATIC_MAINTENANCE_PERIOD=0.0)


def app_config(pkg, passphrase, directory, **overrides):
    """`pkg`'s Config (main/config.py) at its defaults for a node whose
    sqlite database and bucket directory are in `directory`, on the
    network `passphrase`, with MANUAL_TIMERS and then `overrides` set on
    top, as a node's configuration file or the simulation sets them."""
    cfg = pkg.config.Config()
    cfg.NETWORK_PASSPHRASE = passphrase
    cfg.DATABASE = "sqlite3://" + os.path.join(directory, "node.db")
    cfg.BUCKET_DIR_PATH = os.path.join(directory, "buckets")
    for k, v in dict(MANUAL_TIMERS, **overrides).items():
        setattr(cfg, k, v)
    return cfg


def start_app(pkg, cfg, clock=None, start=True):
    """`pkg`'s Application (main/application.py) of `cfg` on `clock` (a
    virtual clock of its own when None), on a new database, started
    (genesis at the config's protocol, the herder, and for a FORCE_SCP
    validator its bootstrap) unless `start` is False: the node
    ApplyBucketsWork fills."""
    clock = clock or pkg.timer.VirtualClock(pkg.timer.ClockMode.VIRTUAL_TIME)
    os.makedirs(os.path.dirname(cfg.DATABASE[len("sqlite3://"):]),
                exist_ok=True)
    app = pkg.application.Application.create(clock, cfg)
    if start:
        app.start()
    return app


# the simulation's validator (simulation/simulation.py:59-75 of the JAX
# package): standalone with FORCE_SCP, closing on its own timers
SIMULATION_NODE = dict(NODE_IS_VALIDATOR=True, RUN_STANDALONE=True,
                       FORCE_SCP=True, MANUAL_CLOSE=False,
                       EXPECTED_LEDGER_CLOSE_TIME=1.0, MAX_TX_SET_SIZE=1000)


def archive_commands(root):
    """The get and put commands of a tmpdir archive at `root`, named
    "test", as tests/test_history_catchup.py:136-140 of the JAX package
    sets them."""
    return {"test": {
        "get": f"cp {root}/{{0}} {{1}}",
        "put": f"mkdir -p $(dirname {root}/{{1}}) && cp {{0}} {root}/{{1}}"}}


def catchup_workload(accounts=CLOSE_ACCOUNTS, txs=CLOSE_TXS,
                     ledgers=CATCHUP_LEDGERS, quiet=CATCHUP_QUIET,
                     quiet_txs=CATCHUP_QUIET_TXS, seed=CATCHUP_SEED):
    """Phase 14's closes (close_workload with `quiet` closes and no
    control): ledger 2 votes maxTxSetSize, ledgers 3-4 create the
    accounts, then `quiet` closes of `quiet_txs` payments and `ledgers`
    closes of `txs` payments in phase 13's mix. With the defaults,
    checkpoint 63 holds ledgers 2-63 and checkpoint 127 ledgers
    64-127. Adds each close's signature tuples (collect_signature_tuples
    of its frames) and the flipped envelopes' tuples."""
    from stellar_core_tpu_torch.tx.frame import make_frame
    from stellar_core_tpu_torch.tx.signature_checker import \
        collect_signature_tuples
    from stellar_core_tpu_torch.xdr.transaction import TransactionEnvelope
    wl = close_workload(accounts, txs, ledgers, seed, quiet=quiet,
                        quiet_txs=quiet_txs, control=False)
    nid, flipped = wl["network_id"], set()
    for c in wl["closes"]:
        frames = [make_frame(TransactionEnvelope.from_bytes(b), nid)
                  for b in c["envelopes"]]
        c["tuples"] = collect_signature_tuples(frames, nid)
        for f, kind in zip(frames, c.get("kinds", ())):
            if kind == "flipped":
                flipped.update(collect_signature_tuples([f], nid))
    wl["flipped"] = flipped
    return wl


def catchup_publish(wl, directory):
    """Phase 14's publisher: an Application in `directory`/publisher
    (app_config, start_app) whose history manager publishes every
    checkpoint to the tmpdir archive
    `directory`/archive; genesis, then every close of `wl` (close_data,
    close_ledger, join_completion, as close_run makes them). Returns the
    archive's root, each ledger's header hash, the signature checks each
    close's apply made (the verify cache's hits plus misses during the
    close), the published checkpoint count and the archive's HAS."""
    pkg = close_modules()
    root = os.path.join(directory, "archive")
    app = start_app(pkg, app_config(
        pkg, wl["passphrase"], os.path.join(directory, "publisher"),
        HISTORY=archive_commands(root)))
    lm, nid = app.ledger_manager, wl["network_id"]
    hashes, checks = {}, {}
    undo = counted_verify_cache(pkg.keys)
    try:
        for i, c in enumerate(wl["closes"]):
            lcd = close_data(pkg, lm, nid, c, i)
            pkg.keys.flush_verify_cache_counts()
            lm.close_ledger(lcd)
            lm.join_completion()
            seq = lm.get_last_closed_ledger_num()
            hashes[seq] = lm.get_last_closed_ledger_hash()
            checks[seq] = sum(pkg.keys.flush_verify_cache_counts())
        published = app.history_manager.published_count
    finally:
        undo()
        app.shutdown()
    with open(os.path.join(root, ".well-known", "stellar-history.json")) as f:
        has = pkg.history.HistoryArchiveState.from_json(f.read())
    return {"root": root, "hashes": hashes, "checks": checks,
            "published": published, "has": has}


def counted_prevalidated(signature_checker):
    """Make PrevalidatedVerifier's hit and miss counts exact under the
    staged apply's worker threads (plain attribute increments) by
    putting each lookup under a lock; returns the undo."""
    import threading
    cls, lock = signature_checker.PrevalidatedVerifier, threading.Lock()
    call = cls.__call__

    def locked(self, pub, sig, msg):
        with lock:
            return call(self, pub, sig, msg)
    cls.__call__ = locked
    return lambda: setattr(cls, "__call__", call)


def recorded_catchup(verifier_mod, signature_checker):
    """Record a package's prevalidate_coalesce per call (counts, window,
    k) into the returned list, and count PrevalidatedVerifier under a
    lock (counted_prevalidated), for the package whose `ops.verifier`
    and `tx.signature_checker` modules are given. Returns (the list,
    the undo)."""
    coalesce, inner = [], verifier_mod.prevalidate_coalesce

    def recorded(counts, max_fuse, *a):
        k = inner(counts, max_fuse, *a)
        coalesce.append((list(counts), max_fuse, k))
        return k
    verifier_mod.prevalidate_coalesce = recorded
    undo = counted_prevalidated(signature_checker)

    def undo_all():
        undo()
        verifier_mod.prevalidate_coalesce = inner
    return coalesce, undo_all


def work_batches(work, streaming):
    """Per batch of a finished catchup work, in dispatch order: its
    checkpoints, the PrevalidatedVerifier's hits and misses, whether it
    failed and whether it landed. A streaming work keeps its batches; a
    sequential one has one per applied checkpoint that prevalidated."""
    if streaming:
        return [dict(cps=list(b.cps), hits=b.pv.hits if b.pv else 0,
                     misses=b.pv.misses if b.pv else 0, failed=b.failed,
                     landed=b.pv is not None)
                for b in work.batches]
    return [dict(cps=[cw.checkpoint], hits=cw.prevalidated.hits,
                 misses=cw.prevalidated.misses, failed=False, landed=True)
            for cw in work.applied_checkpoints
            if cw.prevalidated is not None]


def catchup_run(archive_root, passphrase, directory, streaming, to_ledger,
                verifier):
    """One catchup of a fresh Application in `directory` (app_config at
    the native backend, start_app) from the tmpdir
    archive at `archive_root`: StreamingCatchupWork (the node's default,
    CATCHUP_PIPELINE) or the sequential CatchupWork, complete, to
    `to_ledger` (0: the archive's last), holding the archived results
    (verify_results), at batch_grace CATCHUP_GRACE_S. `verifier(app)`
    makes the app's batch verifier, which the work takes from the app as
    the node's does, behind a RecordingVerifier; the verify the works
    fall back to is the package's default_verify, counting its calls.
    prevalidate_coalesce and PrevalidatedVerifier are recorded
    (recorded_catchup). Returns the final state, the LCL number and
    hash, the recorder's dispatches, the batches (work_batches), the
    coalesce calls, the fallback calls, the pipeline's report
    (streaming), the wall, the collector's passes and the work."""
    from stellar_core_tpu_torch.ops import verifier as vmod
    from stellar_core_tpu_torch.tx import signature_checker as sigchk
    pkg = close_modules()
    cu = pkg.catchup
    app = start_app(pkg, app_config(pkg, passphrase, directory))
    rec = app.batch_verifier = RecordingVerifier(verifier(app))
    fallbacks = []

    def verify(pub, sig, msg):
        fallbacks.append(1)
        return sigchk.default_verify(pub, sig, msg)
    archive = pkg.history.make_tmpdir_archive("test", archive_root)
    cls = cu.StreamingCatchupWork if streaming else cu.CatchupWork
    work = cls(app, archive, cu.CatchupConfiguration(to_ledger=to_ledger),
               verify=verify, batch_grace=CATCHUP_GRACE_S)
    lm = app.ledger_manager
    try:
        coalesce, undo = recorded_catchup(vmod, sigchk)
        pauses, undo_gc = collector_pauses()
        try:
            t0 = time.perf_counter()
            state = pkg.work.run_work_to_completion(app, work,
                                                    timeout_virtual=3000)
            wall = time.perf_counter() - t0
            lm.join_completion()
        finally:
            undo_gc()
            undo()
        return dict(
            state=state, lcl=lm.get_last_closed_ledger_num(),
            hash=lm.get_last_closed_ledger_hash(), dispatches=rec.calls,
            batches=work_batches(work, streaming), coalesce=coalesce,
            fallbacks=len(fallbacks),
            report=work.stats.report() if streaming else None,
            wall_s=wall, gc=pauses, work=work)
    finally:
        app.shutdown()


def catchup_problems(run, wl, pub, last):
    """What a catchup run of phase 14 (`run`, catchup_run's result) got
    wrong against the workload `wl` and its publisher `pub`, replaying
    ledgers 2..`last`: the final state, LCL and hash; every checkpoint
    with signatures in exactly one batch, holding the tuples of its
    replay range; each streaming batch fusing the checkpoints
    prevalidate_coalesce chose from the counts the pump saw; every batch
    landed and not failed with 0 misses, the hits summing to the
    signature checks the publisher's apply made over those ledgers, and
    0 fallback calls; every verdict the native verifier's, false exactly
    on the flipped envelopes' tuples. Returns the problems as strings."""
    from stellar_core_tpu_torch.crypto.keys import verify_sig_uncached
    p = []
    if run["state"].name != "WORK_SUCCESS" or run["lcl"] != last or \
            run["hash"] != pub["hashes"][last]:
        p.append(f"ended {run['state'].name} at ledger {run['lcl']} "
                 f"{run['hash'].hex()[:16]}, not at {last} "
                 f"{pub['hashes'][last].hex()[:16]}")
    by_cp = collections.defaultdict(list)
    for seq, c in enumerate(wl["closes"][:last - 1], start=2):
        by_cp[seq | 63].extend(c["tuples"])
    cps = [cp for b in run["batches"] for cp in b["cps"]]
    if sorted(cps) != sorted(cp for cp, ts in by_cp.items() if ts) or \
            len(run["dispatches"]) != len(run["batches"]):
        p.append(f"batches over checkpoints {cps} in "
                 f"{len(run['dispatches'])} dispatches, not each of "
                 f"{sorted(by_cp)} once")
    for b, (items, _, _) in zip(run["batches"], run["dispatches"]):
        want = collections.Counter(t for cp in b["cps"] for t in by_cp[cp])
        if collections.Counter(items) != want:
            p.append(f"the batch of {b['cps']} holds {len(items)} "
                     f"tuples, not its checkpoints' {sum(want.values())}")
        if not b["landed"] or b["failed"] or b["misses"]:
            p.append(f"the batch of {b['cps']}: landed {b['landed']}, "
                     f"failed {b['failed']}, misses {b['misses']}")
    calls = [c for c in run["coalesce"] if sum(c[0][:c[2]])]
    if run["report"] is not None and (
            len(calls) != len(run["batches"]) or any(
                len(b["cps"]) != k or len(d[0]) != sum(counts[:k])
                for b, d, (counts, _, k) in zip(
                    run["batches"], run["dispatches"], calls))):
        p.append(f"batches {[b['cps'] for b in run['batches']]} do not "
                 f"follow prevalidate_coalesce's calls {run['coalesce']}")
    checks = sum(pub["checks"][s] for s in range(2, last + 1))
    hits = sum(b["hits"] for b in run["batches"])
    if hits != checks or run["fallbacks"]:
        p.append(f"{hits} batch hits for the publisher's {checks} "
                 f"signature checks, {run['fallbacks']} fallback calls")
    for items, got, _ in run["dispatches"]:
        want = [verify_sig_uncached(*t) for t in items]
        false = {t for t, g in zip(items, want) if not g}
        if got != want or false != wl["flipped"] & set(items):
            p.append(f"a batch of {len(items)}: "
                     f"{sum(g != w for g, w in zip(got or [], want))} "
                     f"verdicts off the native verifier's, {len(false)} "
                     "false")
    return p


def held_kernels(items, imad_per_s, tag):
    """Both msg32-path kernels on the rows of one dispatch of a path
    (`items`, the tuples in dispatch order), on the card: each held byte
    for byte (K, -A and OK of prep; x and y of the ladder) against its
    plain version once, then timed (CUDA events, median of 25 launches
    after 3), beside its bound, as phase 3 does at n = N. Exits, naming
    `tag`, on a mismatch. Returns {"prep": ..., "ladder": ...} with n,
    ms, plain_ms, bound_ms, bound_by, max_abs_err."""
    from stellar_core_tpu_torch.ops import ed25519_kernel as EK
    from stellar_core_tpu_torch.ops import ladder as LD
    dev = torch.device("cuda", 0)
    n = len(items)
    pubs, sigs, msgs = rows(items)

    def on_card(arr):
        return torch.from_numpy(np.array(arr)).to(dev)
    a, r, s = on_card(pubs), on_card(sigs[:, :32]), on_card(sigs[:, 32:])
    m = on_card(np.frombuffer(b"".join(msgs), np.uint8).reshape(n, 32))
    out = {}
    got = EK.prep(a, r, s, m, EK.MODE_MSG32)
    want, plain_ms = once_ms(lambda: EK.prep_plain(a, r, s, m, EK.MODE_MSG32))
    b_ops = n * EK.prep_products(EK.MODE_MSG32) / imad_per_s * 1e3
    b_mem = n * (128 + 32 + 64 + 1) / HBM_BYTES_PER_S * 1e3
    out["prep"] = dict(
        n=n, match=all(torch.equal(x, y) for x, y in zip(got, want)),
        max_abs_err=max_abs_err(got, want), plain_ms=plain_ms,
        ms=median_ms(lambda: EK.prep(a, r, s, m, EK.MODE_MSG32)),
        bound_ms=max(b_ops, b_mem),
        bound_by="operations" if b_ops >= b_mem else "bytes")
    k, neg_a = got[0], got[1]
    nax, nay = neg_a[:, :32].contiguous(), neg_a[:, 32:].contiguous()
    got = LD.ladder(s, k, nax, nay)
    want, plain_ms = once_ms(lambda: LD.ladder_plain(s, k, nax, nay))
    s_np, k_np = s.cpu().numpy().tobytes(), k.cpu().numpy().tobytes()
    b_ops = ladder_products([s_np[32 * i:32 * i + 32] for i in range(n)],
                            [k_np[32 * i:32 * i + 32] for i in range(n)]) \
        / imad_per_s * 1e3
    b_mem = n * (4 * 32 + 2 * 32) / HBM_BYTES_PER_S * 1e3
    out["ladder"] = dict(
        n=n, match=all(torch.equal(x, y) for x, y in zip(got, want)),
        max_abs_err=max_abs_err(got, want), plain_ms=plain_ms,
        ms=median_ms(lambda: LD.ladder(s, k, nax, nay)),
        bound_ms=max(b_ops, b_mem),
        bound_by="operations" if b_ops >= b_mem else "bytes")
    for name, e in out.items():
        if not e["match"]:
            raise SystemExit(f"{tag}: {name} disagrees with its plain "
                             f"version at n={n}")
    return out


def catchup_phase(card, imad_per_s=None, accounts=CLOSE_ACCOUNTS,
                  txs=CLOSE_TXS, ledgers=CATCHUP_LEDGERS,
                  quiet=CATCHUP_QUIET, quiet_txs=CATCHUP_QUIET_TXS):
    """Phase 14: catchup (BASELINE.json config #3) from a local archive,
    each checkpoint's signatures verified on the card in one dispatch.
    The publisher (catchup_publish) closes catchup_workload(accounts,
    txs, ledgers, quiet, quiet_txs) with the node's staged apply and
    publishes each checkpoint to a tmpdir archive through `cp`. Two runs
    on fresh nodes in a fresh temporary directory (which also holds the
    works' downloads, and is removed), each with the app's
    batch verifier BackendSupervisor(CudaBatchVerifier()) at the node's
    defaults (phase 7's LIVE: device cutoff 16, dispatch deadline 2000
    ms, canary 16) on the app's clock, at batch_grace CATCHUP_GRACE_S:
    run A1, StreamingCatchupWork complete (the node's default path), and
    run A2, the sequential CatchupWork to CATCHUP_TO. The launch
    counters are set to 0 just before each run and read just after.
    Fails unless each run passes catchup_problems (LCL and hash, every
    checkpoint in one batch of its tuples, the coalescing, hits equal to
    the publisher's signature checks, 0 misses, 0 failed, 0 fallback
    calls, the native verdicts), prep msg32 launches equal ladder
    launches equal the device dispatches equal the batches, with no k
    launch, and the supervisor ends CLOSED with 0 failures, 0 skips and
    dispatches equal to the batches. With `imad_per_s`, held_kernels
    holds and times both kernels on the largest dispatch's rows. Prints the
    publisher, each run (batches, dispatch to landing, the coalesce
    calls, replayed ledgers per second, the collector's passes) and A1's
    PipelineStats report. Returns the launches of both runs by kernel
    and the kernel times (or None)."""
    from stellar_core_tpu_torch.ops.backend_supervisor import (
        CLOSED, BackendSupervisor)
    from stellar_core_tpu_torch.ops.verifier import CudaBatchVerifier
    from stellar_core_tpu_torch.util.metrics import MetricsRegistry

    t0 = time.perf_counter()
    wl = catchup_workload(accounts, txs, ledgers, quiet, quiet_txs)
    build_s = time.perf_counter() - t0
    last = len(wl["closes"]) + 1
    work = tempfile.mkdtemp(prefix="chip-smoke-catchup-")
    # the works' download directories (tempfile.mkdtemp, which the
    # sequential work never removes) go under `work`
    tempdir, tempfile.tempdir = tempfile.tempdir, work
    try:
        t0 = time.perf_counter()
        pub = catchup_publish(wl, work)
        publish_s = time.perf_counter() - t0
        if pub["published"] != (last + 1) // 64 or \
                pub["has"].current_ledger != last or last % 64 != 63:
            raise SystemExit(f"catchup: the publisher closed to {last} and "
                             f"published {pub['published']} checkpoints, "
                             f"HAS at {pub['has'].current_ledger}")
        runs, launches = {}, {"msg32": 0, "k": 0, "ladder": 0}
        for tag, streaming, target in (("A1", True, last),
                                       ("A2", False, CATCHUP_TO)):
            reg, sups = MetricsRegistry(), []

            def verifier(app):
                sups.append(BackendSupervisor(
                    CudaBatchVerifier(
                        perf=app.perf, metrics=reg,
                        device_min_batch=LIVE["device_min_batch"]),
                    clock=app.clock, metrics=reg, perf=app.perf,
                    dispatch_deadline_ms=LIVE["dispatch_deadline_ms"],
                    canary_batch=LIVE["canary_batch"]))
                return sups[0]
            zero_launches()
            run = catchup_run(pub["root"], wl["passphrase"],
                              os.path.join(work, tag), streaming,
                              0 if streaming else target, verifier)
            got = launch_counts()
            st = sups[0].status()
            sups[0].shutdown()
            device = reg.to_json().get("crypto.verify.dispatch.batch",
                                       {}).get("count", 0)
            batches = len(run["dispatches"])
            problems = catchup_problems(run, wl, pub, target)
            if got != {"msg32": device, "k": 0, "ladder": device} or \
                    device != batches or not batches:
                problems.append(f"launched {got} for {device} device "
                                f"dispatches and {batches} batches")
            if st["state"] != CLOSED or any(st["failures"].values()) or \
                    st["skips"] or st["transitions"] or \
                    st["dispatches"] != batches:
                problems.append(f"supervisor: {st['state']}, failures "
                                f"{st['failures']}, skips {st['skips']}, "
                                f"transitions {st['transitions']}, "
                                f"dispatches {st['dispatches']}")
            if problems:
                raise SystemExit(f"catchup run {tag}: " + "; ".join(problems))
            runs[tag] = (run, st)
            for k in launches:
                launches[k] += got[k]
        big = max((d for run, _ in runs.values() for d in run["dispatches"]),
                  key=lambda d: len(d[0]))
        kernels = held_kernels(big[0], imad_per_s, "catchup") \
            if imad_per_s else None
    finally:
        tempfile.tempdir = tempdir
        shutil.rmtree(work, ignore_errors=True)

    print(f"catchup: {accounts} accounts, {quiet} closes of {quiet_txs} and "
          f"{ledgers} of {txs} one-Payment transactions (phase 13's mix), "
          f"built in {build_s:.3f} s; the publisher closed ledgers 2-{last} "
          f"and published {pub['published']} checkpoints in "
          f"{publish_s:.3f} s (HAS current_ledger "
          f"{pub['has'].current_ledger}) [{card}]", flush=True)
    for tag, (run, st) in runs.items():
        gc_s = [t for _, t in run["gc"]]
        full = [t for g, t in run["gc"] if g == 2]
        print(f"  run {tag} ({type(run['work']).__name__}): LCL {run['lcl']} "
              f"{run['hash'].hex()[:16]} (the publisher's) in "
              f"{run['wall_s']:.3f} s, "
              f"{(run['lcl'] - 1) / run['wall_s']:.2f} replayed ledgers/s; "
              f"batches " + ", ".join(
                  f"{b['cps']}: {len(d[0])} tuples, dispatch to "
                  f"landing {d[2] * 1e3:.2f} ms, hits {b['hits']} misses "
                  f"{b['misses']}"
                  for b, d in zip(run["batches"], run["dispatches"]))
              + f"; coalesce calls {run['coalesce']}; fallback calls "
              f"{run['fallbacks']}; supervisor dispatches "
              f"{st['dispatches']}, CLOSED; collector {len(gc_s)} passes "
              f"{sum(gc_s):.3f} s, {len(full)} full "
              f"{sum(full):.3f} s (max {max(full, default=0.0):.3f} s) "
              f"[{card}]", flush=True)
    print("catchup A1 stages: " + json.dumps(runs["A1"][0]["report"]),
          flush=True)
    if kernels:
        for name, e in kernels.items():
            print(f"catchup {name}[msg32] at n={e['n']}: {e['ms']:.4f} ms "
                  f"(plain {e['plain_ms']:.1f} ms, matches; bound "
                  f"{e['bound_ms']:.4f} ms = {e['bound_ms'] / e['ms']:.4f} "
                  f"of the time) [{card}]", flush=True)
    return launches, kernels


def consensus_loopback(pkg, herders, clock, corrupt_first=False):
    """The overlay's stand-in among `herders` on one clock. Each herder's
    broadcast_cb keeps the envelope's bytes and posts, for every other
    herder, its delivery on the next crank: the sender's tx sets the
    statement names and its quorum set, each made anew from its XDR bytes
    and handed over through recv_tx_set and recv_scp_quorum_set where the
    receiver lacks it (in place of the overlay's fetch), then the envelope
    from its bytes through recv_scp_envelope. With `corrupt_first`, the
    first envelope of the first herder reaches each other herder once
    more, with its last signature byte flipped, before the intact one.
    Returns each herder's broadcast envelopes, as bytes, in order."""
    pe = pkg.pending_envelopes
    nid = herders[0].network_id
    emitted = [[] for _ in herders]

    def deliver(j, raw, bad, txsets, qset):
        h = herders[j]
        for th, cls, b in txsets:
            if h.pending_envelopes.get_tx_set(th) is None:
                h.recv_tx_set(th, pkg.tx_set.TxSetFrame(cls.from_bytes(b),
                                                        nid))
        if qset is not None and h.pending_envelopes.get_qset(qset[0]) is None:
            h.recv_scp_quorum_set(
                qset[0], pkg.scp_xdr.SCPQuorumSet.from_bytes(qset[1]))
        for b in ((bad, raw) if bad else (raw,)):
            h.recv_scp_envelope(pkg.scp_xdr.SCPEnvelope.from_bytes(b))

    def broadcast(i, env):
        raw = env.to_bytes()
        emitted[i].append(raw)
        src = herders[i].pending_envelopes
        txsets = []
        for th in sorted(pe._statement_txset_hashes(env.statement)):
            f = src.get_tx_set(th)
            if f is not None:
                x = f.to_xdr()
                txsets.append((th, type(x), x.to_bytes()))
        qh = pe._statement_qset_hash(env.statement)
        q = None if qh is None else src.get_qset(qh)
        qset = None if q is None else (qh, q.to_bytes())
        bad = None
        if corrupt_first and i == 0 and len(emitted[0]) == 1:
            bad = raw[:-1] + bytes([raw[-1] ^ 1])
        for j in range(len(herders)):
            if j != i:
                clock.post(lambda j=j: deliver(j, raw, bad, txsets, qset))

    for i, h in enumerate(herders):
        h.broadcast_cb = lambda env, i=i: broadcast(i, env)
    return emitted


def consensus_run(wl, directory, pkg=None, services=None,
                  nodes=CONSENSUS_NODES, burst=CONSENSUS_BURST,
                  corrupt_first=False, snapshot=None):
    """Phase 15's network: `nodes` validators (each `pkg`'s Application
    in `directory`/node<i> of app_config on the workload's passphrase
    with topologies.core's seed and quorum set and SIMULATION_NODE, at
    the native backend, whose herder's Upgrades vote maxTxSetSize
    CLOSE_MAX_TX_SET from the first slot) on one VirtualClock in
    VIRTUAL_TIME, joined by consensus_loopback in place of the overlay
    (each herder's broadcast goes to it, and no overlay peer is ever
    connected), then started (Application.start: genesis, Herder.start,
    then bootstrap). `services(i, clock)` gives node i's (verify
    service, batch verifier), set where the Application sets those of
    the device backend (the app, its herder, its ledger manager's
    prewarm); None: both None, all native. Each close's LedgerCloseMeta
    is kept from the ledger manager's meta stream. For each close of
    `wl` (close_workload's; close k is slot k + 2, its upgrades voted by
    the herders instead), every
    node admits the close's envelopes, each node its own frames made
    from the bytes, through recv_transactions(frames, bad_sig=...) in
    bursts of `burst`, burst by burst and node by node; then the clock
    is cranked until every node has closed the slot (the nodes trigger
    on their own timers). `snapshot(i)`, where given, is taken of node i
    before and after each burst and each slot. Records per node: the
    broadcast envelopes (bytes), the externalized (slot, value) pairs,
    the AddResult names and bad_sig lists per burst, the verdict of
    every verify_envelope (slot, signer, verdict, signed message's
    length) and of every verify_stellar_value_signature (the node's next
    slot, verdict); per close the header, its hash, the result pairs and
    the LedgerCloseMeta as bytes; per slot the wall from the first
    trigger to every node closed, the crank's wall, node by node the
    ledger.close.* zones and the collector's passes; the
    _LazyBatchPrevalidator's verify cache probes (hits, misses); every
    node's LCL hash."""
    pkg = pkg or close_modules()
    clock = pkg.timer.VirtualClock(pkg.timer.ClockMode.VIRTUAL_TIME)
    seeds = [hashlib.sha256(b"topo-core-%d" % i).digest()
             for i in range(nodes)]
    validators = [pkg.keys.SecretKey.from_seed(s).public_key().raw
                  for s in seeds]
    herders, metas = [], []
    rec = dict(externalized=[[] for _ in seeds], envelopes=[[] for _ in seeds],
               values=[[] for _ in seeds], triggers={}, bursts=[], slots=[],
               probes=[0, 0])

    def wrap(i, h):
        ext, verify_env = h.value_externalized_from_scp, h.verify_envelope
        verify_sv, trigger = (h.verify_stellar_value_signature,
                              h.trigger_next_ledger_scp)

        def externalized(slot, value):
            rec["externalized"][i].append((slot, bytes(value)))
            return ext(slot, value)

        def envelope(env):
            ok = verify_env(env)
            rec["envelopes"][i].append((
                env.statement.slotIndex,
                validators.index(bytes(env.statement.nodeID.value)), ok,
                len(pkg.scp_driver.scp_envelope_sign_bytes(
                    h.network_id, env.statement))))
            return ok

        def value(sv):
            ok = verify_sv(sv)
            rec["values"][i].append(
                (h.ledger_manager.get_last_closed_ledger_num() + 1, ok))
            return ok

        def triggered():
            slot = h.ledger_manager.get_last_closed_ledger_num() + 1
            rec["triggers"].setdefault(slot, time.perf_counter())
            return trigger()
        h.value_externalized_from_scp = externalized
        h.verify_envelope = envelope
        h.verify_stellar_value_signature = value
        h.trigger_next_ledger_scp = triggered

    qset = pkg.config.QuorumSetConfig(threshold=(2 * nodes + 2) // 3,
                                      validators=validators)
    apps = []
    for i, seed in enumerate(seeds):
        cfg = app_config(pkg, wl["passphrase"],
                         os.path.join(directory, f"node{i}"),
                         NODE_SEED=pkg.keys.SecretKey.from_seed(seed),
                         QUORUM_SET=qset, **SIMULATION_NODE)
        app = start_app(pkg, cfg, clock, start=False)
        apps.append(app)
        svc, bv = services(i, clock) if services else (None, None)
        metas.append([])
        app.ledger_manager.meta_stream = metas[i].append
        app.verify_service = app.herder.verify_service = \
            app.ledger_manager.verify_service = svc
        app.batch_verifier = app.herder.batch_verifier = bv
        h = app.herder
        h.upgrades.set_parameters(pkg.upgrades.UpgradeParameters(
            upgrade_time=0, max_tx_set_size=CLOSE_MAX_TX_SET))
        wrap(i, h)
        herders.append(h)
    emitted = consensus_loopback(pkg, herders, clock, corrupt_first)
    probe = pkg.keys.probe_verify_cache

    def counted_probe(*t):
        hit = probe(*t)
        rec["probes"][hit is None] += 1
        return hit
    pkg.keys.probe_verify_cache = counted_probe
    pauses, undo_gc = collector_pauses()
    snap = snapshot or (lambda i: None)
    nid = wl["network_id"]
    try:
        for app in apps:
            app.start()
        for k, c in enumerate(wl["closes"]):
            slot = k + 2
            frames = [[pkg.frame.make_frame(
                pkg.transaction.TransactionEnvelope.from_bytes(b), nid)
                for b in c["envelopes"]] for _ in herders]
            for b0 in range(0, len(c["envelopes"]), burst):
                for i, h in enumerate(herders):
                    bad, before = [], snap(i)
                    t0 = time.perf_counter()
                    res = h.recv_transactions(frames[i][b0:b0 + burst],
                                              bad_sig=bad)
                    rec["bursts"].append(dict(
                        slot=slot, node=i, at=b0,
                        n=len(frames[i][b0:b0 + burst]),
                        wall_s=time.perf_counter() - t0,
                        adds=[r.name for r in res], bad_sig=bad,
                        before=before, after=snap(i)))
            before = [snap(i) for i in range(len(herders))]
            zones = [h.ledger_manager.perf.report() for h in herders]
            gc0 = len(pauses)
            t0 = time.perf_counter()
            done = clock.crank_until(lambda: all(
                h.ledger_manager.get_last_closed_ledger_num() >= slot
                for h in herders), CONSENSUS_TIMEOUT_S)
            wall = time.perf_counter() - t0
            for h in herders:
                h.ledger_manager.join_completion()
            if not done:
                raise SystemExit(f"consensus: slot {slot} did not close on "
                                 "every node within "
                                 f"{CONSENSUS_TIMEOUT_S} virtual seconds")
            after = [h.ledger_manager.perf.report() for h in herders]
            rec["slots"].append(dict(
                slot=slot, tag=c["tag"], wall_s=wall,
                from_trigger_s=time.perf_counter()
                - rec["triggers"].get(slot, t0),
                before=before, after=[snap(i) for i in range(len(herders))],
                gc_s=sum(t for _, t in pauses[gc0:]),
                gc_full=sum(g == 2 for g, _ in pauses[gc0:]),
                zones_ms=[{z: a.get(f"ledger.close.{z}", {}).get(
                    "total_ms", 0.0) - b.get(f"ledger.close.{z}", {}).get(
                    "total_ms", 0.0) for z in CLOSE_ZONES}
                    for a, b in zip(after, zones)]))
        closes = [[dict(
            header=m.value.ledgerHeader.header.to_bytes(),
            hash=bytes(m.value.ledgerHeader.hash),
            results=[t.result.to_bytes() for t in m.value.txProcessing],
            meta=m.to_bytes()) for m in ms] for ms in metas]
        lcl = [h.ledger_manager.get_last_closed_ledger_hash()
               for h in herders]
    finally:
        undo_gc()
        pkg.keys.probe_verify_cache = probe
        for app in apps:
            app.shutdown()
    rec.update(emitted=emitted, closes=closes, lcl=lcl, gc=pauses,
               validators=validators)
    return rec


def consensus_expected(n, max_batch, min_batch):
    """What one flood burst of `n` single-signature transactions, none
    already in the node's verify service, must do: floor(n / max_batch)
    `batch_full` flushes, then one `demand` flush of the remainder when
    recv_transactions awaits its first future; each flush of at least
    `min_batch` a device dispatch with one prep msg32 and one ladder
    launch, each smaller one the verifier's native bypass."""
    flushes = [max_batch] * (n // max_batch) + \
        ([n % max_batch] if n % max_batch else [])
    device = sum(f >= min_batch for f in flushes)
    return dict(batch_full=n // max_batch, demand=int(bool(n % max_batch)),
                device=device, bypass=len(flushes) - device,
                launches={"msg32": device, "k": 0, "ladder": device})


def consensus_phase(card, imad_per_s, accounts=CLOSE_ACCOUNTS, txs=CLOSE_TXS,
                    ledgers=CONSENSUS_LEDGERS):
    """Phase 15: consensus and flood admission (the first slice of
    BASELINE.json config #5, without the overlay and the simulation):
    CONSENSUS_NODES validators of topologies.core on one VirtualClock,
    each a port Herder over its own LedgerManager (consensus_run), on
    core's network. The closes are close_workload's, `flooded` (slot 2
    votes maxTxSetSize CLOSE_MAX_TX_SET through the herders'
    Upgrades, slots 3-4 create `accounts` accounts, then `ledgers`
    measured slots of `txs` one-Payment transactions in phase 13's mix),
    each admitted by every node in bursts of CONSENSUS_BURST. Before the
    runs, held_kernels holds both kernels against their plain versions
    on the rows of the first measured burst, in the order the burst
    submits them, and times them there. Run A gives each
    node its own VerifyService(BackendSupervisor(CudaBatchVerifier()))
    at phase 7's defaults as its verify service, and the supervisor as
    its batch verifier; run B gives none (all native).
    The oracle verdicts of every admitted signature come from worker
    processes before the runs; the launch counters are set to 0 just
    before run A and read just after. Fails unless every node
    externalizes the same value in every slot, once; every node lands on
    one LCL hash, equal to run B's; every close's header, hash, result
    pairs and LedgerCloseMeta are equal on every node and in both runs;
    the emitted envelopes, externalized values and every verify_envelope
    and StellarValue verdict are equal in both runs, and all true; each
    bad_sig list is true exactly on the flipped transactions, which
    alone fail admission; every flood flush equals the oracle; each
    burst's flushes by reason, device dispatches, bypasses and launches
    are those consensus_expected gives; every consensus verify goes to a
    flush of its own or is a hit of the node's service (counted by
    route: device, native bypass, hit), and prep k launches equal the
    consensus flushes that reach the cutoff; the staged apply's prewarm
    flushes nothing (every tuple a hit of the node's service); txset
    validation's _LazyBatchPrevalidator probes the verify cache no time
    and dispatches nothing (each node's own proposal seeds its validity
    cache, and all four build the same txset); the measured closes apply every admitted transaction with
    txSUCCESS; each supervisor ends CLOSED with 0 failures and 0 skips
    and each service with 0 fallbacks. Prints the mix per node per
    measured ledger (tx-hash, StellarValue and envelope signatures, the
    envelopes' signed sizes), the flushes' walls, each slot's wall from
    the first trigger to every node closed, each close's ledger.close.*
    zones and the collector's passes. Returns the launches of run A by
    kernel and held_kernels' result."""
    from stellar_core_tpu_torch.crypto import ed25519_ref as ref
    from stellar_core_tpu_torch.crypto.keys import clear_verify_cache
    from stellar_core_tpu_torch.ops.backend_supervisor import (
        CLOSED, BackendSupervisor)
    from stellar_core_tpu_torch.ops.verifier import CudaBatchVerifier
    from stellar_core_tpu_torch.ops.verify_service import VerifyService
    from stellar_core_tpu_torch.tx.frame import make_frame
    from stellar_core_tpu_torch.tx.signature_checker import \
        collect_signature_tuples
    from stellar_core_tpu_torch.util.metrics import MetricsRegistry
    from stellar_core_tpu_torch.util.perf import ZoneRegistry
    from stellar_core_tpu_torch.xdr.results import (TransactionResultCode,
                                                    TransactionResultPair)
    from stellar_core_tpu_torch.xdr.transaction import TransactionEnvelope

    t0 = time.perf_counter()
    wl = close_workload(accounts, txs, ledgers, CONSENSUS_SEED,
                        control=False, flooded=True)
    build_s = time.perf_counter() - t0
    nid = wl["network_id"]
    flood = sorted({t for c in wl["closes"] for t in collect_signature_tuples(
        [make_frame(TransactionEnvelope.from_bytes(b), nid)
         for b in c["envelopes"]])})
    min_batch = LIVE["device_min_batch"]
    burst = CONSENSUS_BURST
    first = next(c for c in wl["closes"] if c["tag"] == "measured")
    kernels = held_kernels(collect_signature_tuples([
        make_frame(TransactionEnvelope.from_bytes(b), nid)
        for b in first["envelopes"][:burst]]), imad_per_s, "consensus")
    stacks = []

    def services(i, clock):
        reg, perf = MetricsRegistry(), ZoneRegistry()
        sup = BackendSupervisor(
            CudaBatchVerifier(perf=perf, metrics=reg,
                              device_min_batch=min_batch),
            clock=clock, metrics=reg, perf=perf,
            dispatch_deadline_ms=LIVE["dispatch_deadline_ms"],
            canary_batch=LIVE["canary_batch"])
        rec = RecordingVerifier(sup)
        svc = VerifyService(rec, clock=clock, metrics=reg, perf=perf,
                            max_batch=LIVE["max_batch"],
                            deadline_ms=LIVE["deadline_ms"])
        batch = RecordingVerifier(sup)
        stacks.append(dict(sup=sup, rec=rec, svc=svc, batch=batch, reg=reg,
                           perf=perf))
        return svc, batch

    def snapshot(i):
        s = stacks[i]
        st = s["svc"].stats()
        return dict(
            reasons=dict(st["flush_reasons"]), calls=len(s["rec"].calls),
            device=s["reg"].to_json()["crypto.verify.dispatch.batch"][
                "count"],
            bypass=s["perf"].report().get("crypto.batchVerify.native",
                                          {"count": 0})["count"],
            launches=launch_counts())

    work = tempfile.mkdtemp(prefix="chip-smoke-consensus-")
    pool = multiprocessing.get_context("spawn").Pool(
        max(1, min(7, (os.cpu_count() or 2) - 1)))
    try:
        t0 = time.perf_counter()
        want = dict(zip(flood, pool.starmap(ref.verify, flood,
                                            chunksize=64)))
        oracle_s = time.perf_counter() - t0
        pool.close()
        clear_verify_cache()
        zero_launches()
        t0 = time.perf_counter()
        a = consensus_run(wl, os.path.join(work, "a"), services=services,
                          snapshot=snapshot)
        a_s = time.perf_counter() - t0
        launches = launch_counts()
        clear_verify_cache()
        zero_launches()
        t0 = time.perf_counter()
        b = consensus_run(wl, os.path.join(work, "b"))
        b_s = time.perf_counter() - t0
        b_launches = launch_counts()
    finally:
        pool.terminate()
        pool.join()
        shutil.rmtree(work, ignore_errors=True)
    sts = [s["sup"].status() for s in stacks]
    stats = [s["svc"].stats() for s in stacks]
    for s in stacks:
        s["sup"].shutdown()

    problems = []
    n = len(stacks)
    slots = [k + 2 for k in range(len(wl["closes"]))]
    for i in range(n):
        if a["externalized"][i] != a["externalized"][0] or \
                [sl for sl, _ in a["externalized"][i]] != slots:
            problems.append(f"node {i} externalized slots "
                            f"{[sl for sl, _ in a['externalized'][i]]}, not "
                            f"node 0's values once each in {slots}")
        if a["closes"][i] != a["closes"][0]:
            problems.append(f"node {i}'s closes differ from node 0's")
    if len(set(a["lcl"])) != 1 or a["lcl"] != b["lcl"]:
        problems.append(f"LCL A {[h.hex()[:16] for h in a['lcl']]} B "
                        f"{[h.hex()[:16] for h in b['lcl']]}")
    for key in ("closes", "emitted", "externalized", "envelopes", "values"):
        if a[key] != b[key]:
            problems.append(f"runs A and B differ in {key}")
    bad_verdicts = sum(not e[2] for es in a["envelopes"] for e in es) + \
        sum(not v for vs in a["values"] for _, v in vs)
    if bad_verdicts:
        problems.append(f"{bad_verdicts} consensus signatures rejected")
    if any(b_launches.values()):
        problems.append(f"run B launched {b_launches}")
    flipped = [[j for j, kind in enumerate(c.get("kinds", ()))
                if kind == "flipped"] for c in wl["closes"]]
    want_launch = {"msg32": 0, "k": 0, "ladder": 0}
    for bu in a["bursts"]:
        k = bu["slot"] - 2
        want_bad = [bu["at"] + j in flipped[k] for j in range(bu["n"])]
        if bu["bad_sig"] != want_bad or [r != "ADD_STATUS_PENDING"
                                         for r in bu["adds"]] != want_bad:
            problems.append(f"slot {bu['slot']} node {bu['node']} burst at "
                            f"{bu['at']}: bad_sig {sum(bu['bad_sig'])}, "
                            f"adds {collections.Counter(bu['adds'])}, "
                            f"flipped {sum(want_bad)}")
        exp = consensus_expected(bu["n"], LIVE["max_batch"], min_batch)
        s0, s1 = bu["before"], bu["after"]
        got = dict(batch_full=s1["reasons"]["batch_full"]
                   - s0["reasons"]["batch_full"],
                   demand=s1["reasons"]["demand"] - s0["reasons"]["demand"],
                   device=s1["device"] - s0["device"],
                   bypass=s1["bypass"] - s0["bypass"],
                   launches={m: s1["launches"][m] - s0["launches"][m]
                             for m in s0["launches"]})
        if got != exp or any(r != "batch_full" and r != "demand" and
                             s1["reasons"][r] != s0["reasons"][r]
                             for r in s0["reasons"]):
            problems.append(f"slot {bu['slot']} node {bu['node']} burst at "
                            f"{bu['at']} of {bu['n']}: {got}, expected {exp}")
        for m in want_launch:
            want_launch[m] += exp["launches"][m]
    # each node's flushes by kind: flood (32-byte tx hashes, inside a
    # burst), StellarValue (76 bytes), envelope (the rest)
    mix, flood_off = [], 0
    for i, s in enumerate(stacks):
        in_burst = set()
        for bu in a["bursts"]:
            if bu["node"] == i:
                in_burst.update(range(bu["before"]["calls"],
                                      bu["after"]["calls"]))
        route = {(kd, r): 0 for kd in ("value", "envelope")
                 for r in ("device", "bypass")}
        k_flushes = 0
        for c, (items, got, _) in enumerate(s["rec"].calls):
            lens = {len(m) for _, _, m in items}
            if c in in_burst:
                if lens != {32}:
                    problems.append(f"node {i}: a flood flush holds a "
                                    f"message of {sorted(lens)} bytes")
                flood_off += sum(g != want.get(t) for t, g in zip(items, got))
                continue
            if lens == {32}:
                problems.append(f"node {i}: a flush of {len(items)} tx "
                                "hashes outside the bursts (the prewarm)")
                continue
            k_flushes += len(items) >= min_batch
            for (_, _, m), g in zip(items, got):
                kd = "value" if len(m) == 76 else "envelope"
                route[(kd, "device" if len(items) >= min_batch
                       else "bypass")] += 1
        calls = {"value": len(a["values"][i]),
                 "envelope": len(a["envelopes"][i])}
        hits = {kd: calls[kd] - route[(kd, "device")]
                - route[(kd, "bypass")] for kd in calls}
        if any(h < 0 for h in hits.values()):
            problems.append(f"node {i}: more consensus verifies flushed "
                            f"than called: {route}, calls {calls}")
        want_launch["k"] += k_flushes
        mix.append(dict(route=route, hits=hits, calls=calls,
                        k_flushes=k_flushes))
        if s["batch"].calls:
            problems.append(f"node {i}: txset validation dispatched "
                            f"{[len(c[0]) for c in s['batch'].calls]}")
    want_launch["ladder"] = want_launch["msg32"] + want_launch["k"]
    if flood_off:
        problems.append(f"{flood_off} flood verdicts differ from the oracle")
    if launches != want_launch:
        problems.append(f"run A launched {launches}, the bursts and "
                        f"consensus flushes give {want_launch}")
    if a["probes"] != [0, 0]:
        problems.append(f"txset validation's prevalidator: {a['probes'][0]} "
                        f"hits, {a['probes'][1]} misses (every node's own "
                        "proposal seeds its validity cache, and all build "
                        "the same txset: 0 probes)")
    for i, (st, sv) in enumerate(zip(sts, stats)):
        if st["state"] != CLOSED or any(st["failures"].values()) or \
                st["skips"] or st["transitions"] or sv["fallbacks"]:
            problems.append(f"node {i} supervisor: {st['state']}, failures "
                            f"{st['failures']}, skips {st['skips']}, "
                            f"transitions {st['transitions']}; service "
                            f"fallbacks {sv['fallbacks']}")
    for k, c in enumerate(wl["closes"]):
        if c["tag"] != "measured":
            continue
        codes = collections.Counter(
            TransactionResultPair.from_bytes(r).result.result.disc
            for r in a["closes"][0][k]["results"])
        if codes != {TransactionResultCode.txSUCCESS:
                     len(c["envelopes"]) - len(flipped[k])}:
            problems.append(f"slot {k + 2}: results {dict(codes)}")
    if problems:
        raise SystemExit("consensus: " + "; ".join(problems))

    measured = [k + 2 for k, c in enumerate(wl["closes"])
                if c["tag"] == "measured"]
    print(f"consensus: {n} validators of topologies.core (threshold "
          f"{(2 * n + 2) // 3}) on one virtual clock, {accounts} accounts, "
          f"{ledgers} measured slots of {txs} one-Payment transactions "
          f"(chosen mix {dict(CLOSE_MIX)}), admitted by every node in "
          f"bursts of {burst}; built in {build_s:.3f} s; the oracle of "
          f"{len(flood)} signatures in {oracle_s:.3f} s before the runs; "
          f"run A (verify service, supervisor and kernels per node) "
          f"{a_s:.3f} s, run B (native) {b_s:.3f} s [{card}]", flush=True)
    for i, m in enumerate(mix):
        sizes = collections.Counter(e[3] for e in a["envelopes"][i]
                                    if e[0] in measured)
        values = sum(sl in measured for sl, _ in a["values"][i])
        per = len(measured)
        print(f"  node {i} mix per measured ledger: tx-hash signatures "
              f"{txs}, StellarValue {values / per:.2f}, envelope "
              f"{sum(sizes.values()) / per:.2f}; envelope signed sizes "
              f"{dict(sorted(sizes.items()))}; consensus verifies by route "
              f"(device, bypass, service hit): StellarValue "
              f"{m['route'][('value', 'device')]}/"
              f"{m['route'][('value', 'bypass')]}/{m['hits']['value']}, "
              f"envelope {m['route'][('envelope', 'device')]}/"
              f"{m['route'][('envelope', 'bypass')]}/"
              f"{m['hits']['envelope']}; consensus flushes reaching "
              f"{min_batch}: {m['k_flushes']}", flush=True)
    walls = {kd: [] for kd in ("flood", "consensus")}
    for i, s in enumerate(stacks):
        for bu in a["bursts"]:
            if bu["node"] == i:
                walls["flood"] += [w for _, _, w in s["rec"].calls[
                    bu["before"]["calls"]:bu["after"]["calls"]]]
        walls["consensus"] += [w for items, _, w in s["rec"].calls
                               if {len(m) for _, _, m in items} != {32}]
    for kd, ws in walls.items():
        if ws:
            print(f"  {kd} flushes: {len(ws)}, dispatch to collected min "
                  f"{min(ws) * 1e3:.3f} / median "
                  f"{statistics.median(ws) * 1e3:.3f} / max "
                  f"{max(ws) * 1e3:.3f} ms [{card}]", flush=True)
    bursts = [bu["wall_s"] for bu in a["bursts"] if bu["n"] == burst]
    if bursts:
        print(f"  recv_transactions of {burst}: {len(bursts)} bursts, min "
              f"{min(bursts) * 1e3:.1f} / median "
              f"{statistics.median(bursts) * 1e3:.1f} / max "
              f"{max(bursts) * 1e3:.1f} ms (run A)", flush=True)
    for sa, sb in zip(a["slots"], b["slots"]):
        print(f"  slot {sa['slot']} {sa['tag']}: trigger to every node "
              f"closed A {sa['from_trigger_s'] * 1e3:.1f} ms B "
              f"{sb['from_trigger_s'] * 1e3:.1f} ms (crank A "
              f"{sa['wall_s'] * 1e3:.1f} B {sb['wall_s'] * 1e3:.1f}); "
              f"collector A {sa['gc_s'] * 1e3:.1f} ms ({sa['gc_full']} "
              f"full) B {sb['gc_s'] * 1e3:.1f} ms ({sb['gc_full']} full); "
              f"node 0's zones A " + " ".join(
                  f"{z}={v:.1f}" for z, v in sa["zones_ms"][0].items())
              + " B " + " ".join(f"{z}={v:.1f}"
                                 for z, v in sb["zones_ms"][0].items()),
              flush=True)
    print(f"consensus: launches prep msg32 {launches['msg32']} = ladder "
          f"{launches['ladder']} - k {launches['k']} = the bursts' device "
          f"dispatches; prep k {launches['k']} = consensus flushes reaching "
          f"the cutoff; txset validation probes hits {a['probes'][0]} "
          f"misses {a['probes'][1]}, dispatches 0; supervisors CLOSED, 0 "
          f"failures, 0 skips; services' flushes by reason "
          f"{[s['flush_reasons'] for s in stats]}, fallbacks 0; collector "
          f"passes A {len(a['gc'])} ({sum(g == 2 for g, _ in a['gc'])} "
          f"full, {sum(t for _, t in a['gc']):.3f} s) B {len(b['gc'])} "
          f"({sum(g == 2 for g, _ in b['gc'])} full); every node and both "
          f"runs at LCL {a['lcl'][0].hex()[:16]} [{card}]", flush=True)
    for name, e in kernels.items():
        print(f"consensus {name}[msg32] on one burst's rows, n={e['n']}: "
              f"{e['ms']:.4f} ms (plain {e['plain_ms']:.1f} ms, matches; "
              f"bound {e['bound_ms']:.4f} ms = "
              f"{e['bound_ms'] / e['ms']:.4f} of the time) [{card}]",
              flush=True)
    return launches, kernels


def node_run(backend, load=NODE_LOAD, ledgers=NODE_LEDGERS, after=None):
    """Phase 16's network, as tests/node_mix.py --load runs it: the
    port's simulation/topologies.core(CONSENSUS_NODES) (seeds
    sha256("topo-core-i"), one flat quorum set of threshold 3, network
    CORE_PASSPHRASE, one VirtualClock in virtual time, a
    LoopbackPeerConnection for every pair of nodes through the overlay's
    handshake, MAC and flow control), every node's Config voting
    TESTING_UPGRADE_MAX_TX_SET_SIZE max(load, 100) and selecting
    SIGNATURE_VERIFY_BACKEND `backend`; the Application builds what that
    backend needs. Node 0's LoadGenerator(seed=NODE_LOAD_SEED) submits
    the creation of `load` accounts before the first ledger after
    start, then `load` payments before each of the next `ledgers` - 1;
    Simulation.crank_until drives the network until every node has
    closed each ledger. `after(apps)` runs once the last ledger closed,
    before the nodes stop. Records per node: the externalized (slot,
    value) pairs, each recv_transactions call's frames and wall in
    order, the verify_envelope and StellarValue verifies, the service's
    and the supervisor's state (None on the native backend), the
    overlay's peers report; per close the header, its hash, the result
    pairs and the LedgerCloseMeta as bytes; each ledger's wall; the
    txset prevalidator's verify-cache probes; every node's LCL hash; and
    what `after` returns."""
    from stellar_core_tpu_torch.crypto import keys
    from stellar_core_tpu_torch.simulation import topologies
    from stellar_core_tpu_torch.simulation.load_generator import \
        LoadGenerator

    def configure(cfg):
        cfg.TESTING_UPGRADE_MAX_TX_SET_SIZE = max(load, 100)
        cfg.SIGNATURE_VERIFY_BACKEND = backend
    sim = topologies.core(CONSENSUS_NODES, configure=configure)
    apps = sim.apps()
    n = len(apps)
    rec = dict(externalized=[[] for _ in apps], bursts=[[] for _ in apps],
               consensus=[collections.Counter() for _ in apps],
               metas=[[] for _ in apps], ledgers=[], probes=[0, 0])

    def wrap(i, h):
        ext, recv = h.value_externalized_from_scp, h.recv_transactions
        verify_env, verify_sv = (h.verify_envelope,
                                 h.verify_stellar_value_signature)

        def externalized(slot, value):
            rec["externalized"][i].append((slot, bytes(value)))
            return ext(slot, value)

        def received(frames, bad_sig=None):
            t0 = time.perf_counter()
            out = recv(frames, bad_sig)
            rec["bursts"][i].append((len(frames), time.perf_counter() - t0))
            return out

        def envelope(env):
            rec["consensus"][i]["envelope"] += 1
            return verify_env(env)

        def value(sv):
            rec["consensus"][i]["value"] += 1
            return verify_sv(sv)
        h.value_externalized_from_scp = externalized
        h.recv_transactions = received
        h.verify_envelope = envelope
        h.verify_stellar_value_signature = value
    for i, app in enumerate(apps):
        app.ledger_manager.meta_stream = rec["metas"][i].append
        wrap(i, app.herder)
    probe = keys.probe_verify_cache

    def counted_probe(*t):
        hit = probe(*t)
        rec["probes"][hit is None] += 1
        return hit
    keys.probe_verify_cache = counted_probe
    try:
        sim.start_all_nodes()
        first = min(a.ledger_manager.get_last_closed_ledger_num()
                    for a in apps)
        gen = LoadGenerator(apps[0], seed=NODE_LOAD_SEED)
        gen.generate_accounts(load)
        for seq in range(first + 1, first + 1 + ledgers):
            if seq > first + 1:
                gen.sync_account_seqs()
                gen.generate_payments(load)
            t0 = time.perf_counter()
            if not sim.crank_until(lambda: sim.have_all_externalized(seq),
                                   NODE_TIMEOUT_S):
                raise SystemExit(f"node: ledger {seq} did not close on "
                                 f"every node within {NODE_TIMEOUT_S} "
                                 "virtual seconds")
            rec["ledgers"].append((seq, time.perf_counter() - t0))
        for a in apps:
            a.ledger_manager.join_completion()
        keys.probe_verify_cache = probe
        rec["submitted"], rec["failed"] = gen.submitted, gen.failed
        rec["lcl"] = [a.ledger_manager.get_last_closed_ledger_hash()
                      for a in apps]
        rec["closes"] = [[dict(
            header=m.value.ledgerHeader.header.to_bytes(),
            hash=bytes(m.value.ledgerHeader.hash),
            results=[t.result.to_bytes() for t in m.value.txProcessing],
            meta=m.to_bytes()) for m in ms] for ms in rec.pop("metas")]
        rec["peers"] = [a.overlay_manager.peers_json() for a in apps]
        rec["services"] = [a.verify_service and a.verify_service.stats()
                           for a in apps]
        rec["supervisors"] = [a.batch_verifier and a.batch_verifier.status()
                              for a in apps]
        rec["after"] = after(apps) if after else None
    finally:
        keys.probe_verify_cache = probe
        sim.stop_all_nodes()
    rec["nodes"] = n
    return rec


def node_counts(rec, calls, inner, min_batch):
    """Phase 16's counts in NODE_EXPECTED's shape from run A's record
    (node_run's) and the verifier calls it made (`calls`: [verifier id,
    tuples, verdicts, wall] in dispatch order; `inner[i]` node i's
    verifier id), as tests/node_mix.py --backend counts them."""
    out = {"recv_transactions_calls": [[f for f, _ in b]
                                       for b in rec["bursts"]],
           "verifier": [], "prevalidator_probes": {
               "hits": rec["probes"][0], "misses": rec["probes"][1]},
           "lcl": sorted({h.hex() for h in rec["lcl"]})}
    for i in range(rec["nodes"]):
        sizes = [(len(items), "bypass" if len(items) < min_batch else
                  "msg32" if all(len(m) == 32 for _, _, m in items)
                  else "k")
                 for v, items, _, _ in calls if v == inner[i]]
        by_mode = collections.Counter(mode for _, mode in sizes)
        st = rec["services"][i]
        out["verifier"].append({
            "device": {"msg32": by_mode["msg32"], "k": by_mode["k"]},
            "bypass": by_mode["bypass"],
            "device_sizes": [list(x) for x in sorted(collections.Counter(
                s for s, mode in sizes if mode != "bypass").items())],
            "bypass_sizes": [list(x) for x in sorted(collections.Counter(
                s for s, mode in sizes if mode == "bypass").items())],
            "flush_reasons": {r: c for r, c in sorted(
                st["flush_reasons"].items()) if c},
            "fallbacks": st["fallbacks"],
            "consensus_calls": dict(sorted(rec["consensus"][i].items()))})
    return out


def node_phase(card, imad_per_s, expected=NODE_EXPECTED, load=NODE_LOAD,
               ledgers=NODE_LEDGERS):
    """Phase 16: the node (BASELINE.json config #5, LoadGenerator
    max-TPS across a multi-node topology): node_run's four port
    validators, run A with SIGNATURE_VERIFY_BACKEND "cuda" (each
    Application builds its BackendSupervisor(CudaBatchVerifier()) and
    VerifyService at the node's defaults; nothing here wires a verifier
    into a node), run B "native". While run A runs, every call of
    CudaBatchVerifier.verify_tuples_async is recorded (tuples, verdicts,
    dispatch to collected); once its last ledger closed, self_check
    runs on node 0 (two 1,024-signature batches on a CudaBatchVerifier
    of its own, the service warm-up of max(4, device cutoff) signatures,
    the supervisor's state). The launch counters are set to 0 just
    before run A and read just after self_check. Fails unless every
    node externalizes the same value in every slot, once each; every
    node lands on one LCL, equal to run B's; every close's header,
    hash, result pairs and LedgerCloseMeta are equal on every node and
    in both runs; the counts (node_counts) are `expected`; every device
    flush equals the oracle (worker processes); prep msg32 and ladder
    launches each equal the device dispatches plus self_check's two
    batches, with no k launch unless a device flush held a long
    message; every supervisor ends CLOSED with 0 failures and 0 skips
    and every service with 0 fallbacks; self_check reports ok. Then
    held_kernels holds both kernels against their plain versions on
    the rows of run A's first device flush whose size is not a multiple
    of 32, and times them there. Prints the ledger walls, the bursts'
    walls, the overlay's counters, the bursts per node and self_check's
    device verifies per second beside the card. Returns the launches of
    run A by kernel and held_kernels' result."""
    from stellar_core_tpu_torch.crypto import ed25519_ref as ref
    from stellar_core_tpu_torch.crypto.keys import clear_verify_cache
    from stellar_core_tpu_torch.main.self_check import self_check
    from stellar_core_tpu_torch.ops.backend_supervisor import CLOSED
    from stellar_core_tpu_torch.ops.verifier import CudaBatchVerifier

    calls, inner = [], []
    dispatch = CudaBatchVerifier.verify_tuples_async

    def recorded(self, items):
        entry = [id(self), list(items), None, None]
        calls.append(entry)
        t0 = time.perf_counter()
        collect = dispatch(self, items)

        def done():
            got = collect()
            entry[2], entry[3] = list(got), time.perf_counter() - t0
            return got
        return done

    def after(apps):
        inner.extend(id(a.batch_verifier._inner) for a in apps)
        phase_calls = len(calls)
        t0 = time.perf_counter()
        ok, report = self_check(apps[0])
        return dict(ok=ok, report=report, wall_s=time.perf_counter() - t0,
                    phase_calls=phase_calls)

    min_batch = LIVE["device_min_batch"]
    clear_verify_cache()
    zero_launches()
    CudaBatchVerifier.verify_tuples_async = recorded
    t0 = time.perf_counter()
    try:
        a = node_run("cuda", load, ledgers, after)
    finally:
        CudaBatchVerifier.verify_tuples_async = dispatch
    a_s = time.perf_counter() - t0
    launches = launch_counts()
    clear_verify_cache()
    zero_launches()
    t0 = time.perf_counter()
    b = node_run("native", load, ledgers)
    b_s = time.perf_counter() - t0
    b_launches = launch_counts()

    sc = a["after"]
    phase_calls, warm = calls[:sc["phase_calls"]], calls[sc["phase_calls"]:]
    got = node_counts(a, phase_calls, inner, min_batch)
    device = [c for c in calls if len(c[1]) >= min_batch]
    flood = sorted({t for c in device for t in c[1]})
    pool = multiprocessing.get_context("spawn").Pool(
        max(1, min(7, (os.cpu_count() or 2) - 1)))
    try:
        t0 = time.perf_counter()
        want = dict(zip(flood, pool.starmap(ref.verify, flood,
                                            chunksize=64)))
        oracle_s = time.perf_counter() - t0
        pool.close()
    finally:
        pool.terminate()
        pool.join()

    problems = []
    slots = [s for s, _ in a["externalized"][0]]
    if sorted(set(slots)) != slots or not slots:
        problems.append(f"node 0 externalized slots {slots}")
    for i in range(a["nodes"]):
        if a["externalized"][i] != a["externalized"][0]:
            problems.append(f"node {i} externalized other values or slots "
                            "than node 0")
        if a["closes"][i] != a["closes"][0]:
            problems.append(f"node {i}'s closes differ from node 0's")
    if len(set(a["lcl"])) != 1 or a["lcl"] != b["lcl"]:
        problems.append(f"LCL A {[h.hex()[:16] for h in a['lcl']]} B "
                        f"{[h.hex()[:16] for h in b['lcl']]}")
    for key in ("closes", "externalized"):
        if a[key] != b[key]:
            problems.append(f"runs A and B differ in {key}")
    if got != expected:
        diff = [k for k in expected if got.get(k) != expected[k]]
        problems.append(f"counts off the prediction in {diff}: "
                        + json.dumps({k: got.get(k) for k in diff}))
    off = sum(g != want[t] for c in device for t, g in zip(c[1], c[2]))
    if off:
        problems.append(f"{off} device verdicts differ from the oracle")
    dispatches = {"msg32": sum(all(len(m) == 32 for _, _, m in c[1])
                               for c in device)}
    dispatches["k"] = len(device) - dispatches["msg32"]
    want_launch = {"msg32": dispatches["msg32"] + 2, "k": dispatches["k"],
                   "ladder": len(device) + 2}
    if launches != want_launch:
        problems.append(f"run A launched {launches}; its device dispatches "
                        f"{dispatches} and self_check's two batches give "
                        f"{want_launch}")
    if any(b_launches.values()):
        problems.append(f"run B launched {b_launches}")
    for i, (st, sv) in enumerate(zip(a["supervisors"], a["services"])):
        if st["state"] != CLOSED or any(st["failures"].values()) or \
                st["skips"] or st["transitions"] or sv["fallbacks"]:
            problems.append(f"node {i} supervisor: {st['state']}, failures "
                            f"{st['failures']}, skips {st['skips']}, "
                            f"transitions {st['transitions']}; service "
                            f"fallbacks {sv['fallbacks']}")
    rep = sc["report"]
    if not sc["ok"] or not rep.get("tpu_backend_ok") or \
            not rep.get("verify_service_ok") or \
            [len(c[1]) for c in warm] != [max(4, min_batch)]:
        problems.append(f"self_check: ok {sc['ok']}, report {rep}, service "
                        f"warm-up dispatches {[len(c[1]) for c in warm]}")
    if problems:
        raise SystemExit("node: " + "; ".join(problems))
    first = next(c for c in device if len(c[1]) % 32)
    kernels = held_kernels(first[1], imad_per_s, "node")

    print(f"node: {a['nodes']} validators of the port's topologies.core on "
          f"one virtual clock over loopback links; node 0's load generator "
          f"submitted {a['submitted']} transactions ({a['failed']} not "
          f"pending): {load} accounts, then {load} payments before each of "
          f"{ledgers - 1} ledgers; run A (\"cuda\") {a_s:.3f} s, run B "
          f"(\"native\") {b_s:.3f} s; the oracle of {len(flood)} signatures "
          f"in {oracle_s:.3f} s after the runs [{card}]", flush=True)
    for tag, r in (("A", a), ("B", b)):
        print(f"  run {tag} ledger walls (crank_until, s): " + ", ".join(
            f"{s}: {w:.3f}" for s, w in r["ledgers"]), flush=True)
    for i, bursts in enumerate(a["bursts"]):
        ws = [w for _, w in bursts]
        print(f"  node {i}: {len(bursts)} recv_transactions calls, frames "
              f"{[f for f, _ in bursts]}"
              + (f"; walls min {min(ws) * 1e3:.1f} / median "
                 f"{statistics.median(ws) * 1e3:.1f} / max "
                 f"{max(ws) * 1e3:.1f} ms (run A)" if ws else "")
              + f"; verifier {json.dumps(got['verifier'][i])}", flush=True)
    walls = [c[3] for c in device]
    print(f"  device flushes: {len(device)}, dispatch to collected min "
          f"{min(walls) * 1e3:.3f} / median "
          f"{statistics.median(walls) * 1e3:.3f} / max "
          f"{max(walls) * 1e3:.3f} ms [{card}]", flush=True)
    for i, peers in enumerate(a["peers"]):
        links = peers["inbound"] + peers["outbound"]
        flood_rep = peers.get("flood", {})
        print(f"  node {i} overlay: " + json.dumps({
            "links": [{k: p[k] for k in ("bytes_sent", "bytes_received",
                                         "messages_sent",
                                         "messages_received",
                                         "duplicates", "demand")}
                      for p in links],
            "flood": {k: flood_rep[k] for k in flood_rep
                      if k not in ("by_kind", "encode")},
            "by_kind": flood_rep.get("by_kind")}), flush=True)
    print(f"node: launches prep msg32 {launches['msg32']} = ladder "
          f"{launches['ladder']} = {len(device)} device dispatches (the "
          f"service warm-up's included) + self_check's 2; prep k "
          f"{launches['k']}; txset prevalidator probes hits "
          f"{a['probes'][0]} misses {a['probes'][1]}; supervisors CLOSED, "
          f"0 failures, 0 skips; services' fallbacks 0; every node and "
          f"both runs at LCL {a['lcl'][0].hex()[:16]}; self_check ok in "
          f"{sc['wall_s']:.3f} s, verify_per_second_tpu_batch "
          f"{rep['verify_per_second_tpu_batch']}, verify_per_second_cpu "
          f"{rep['verify_per_second_cpu']} [{card}]", flush=True)
    for name, e in kernels.items():
        print(f"node {name}[msg32] on one flush's rows, n={e['n']}: "
              f"{e['ms']:.4f} ms (plain {e['plain_ms']:.1f} ms, matches; "
              f"bound {e['bound_ms']:.4f} ms = "
              f"{e['bound_ms'] / e['ms']:.4f} of the time) [{card}]",
              flush=True)
    return launches, kernels


def cluster_labels(c, accounts=NODE_LOAD):
    """Who each account of phase 17's ledger is, by its raw key: the
    network root, node 0's load generator accounts ("load i") and the
    flooder's ("flood i"), derived as LoadGenerator.generate_accounts
    derives them from the node's PEER_PORT. The ports change from run to
    run, so two runs are compared by these labels."""
    from stellar_core_tpu_torch.crypto.keys import SecretKey
    from stellar_core_tpu_torch.crypto.sha import sha256
    labels = {SecretKey.from_seed(sha256(c.passphrase.encode()))
              .public_key().raw: "root"}
    for tag, node, n in (("load", c.nodes[0], accounts),
                         ("flood", c.nodes[-1], CLUSTER_FLOOD[0])):
        for i in range(n):
            key = SecretKey.from_seed(sha256(b"loadgen-%d-%d"
                                             % (i, node.peer_port)))
            labels[key.public_key().raw] = f"{tag} {i}"
    return labels


def cluster_ledger(db_path, labels, network_id):
    """A stopped node's sqlite file: every account as {label: (balance,
    seqNum)}, and the applied transactions (txhistory) as a count by the
    label of their source, with the number whose signature does not
    verify against that source (a forged twin that applied would be
    one)."""
    import sqlite3
    from stellar_core_tpu_torch.crypto.keys import PubKeyUtils
    from stellar_core_tpu_torch.tx.frame import make_frame
    from stellar_core_tpu_torch.xdr.ledger_entries import LedgerEntry
    from stellar_core_tpu_torch.xdr.transaction import TransactionEnvelope
    con = sqlite3.connect(f"file:{db_path}?mode=ro", uri=True)
    try:
        rows = con.execute("SELECT entry FROM accounts").fetchall()
        txs = con.execute("SELECT txbody FROM txhistory").fetchall()
    finally:
        con.close()
    accounts = {}
    for (blob,) in rows:
        a = LedgerEntry.from_bytes(bytes(blob)).data.value
        raw = bytes(a.accountID.value)
        accounts[labels.get(raw, "other " + raw.hex()[:16])] = \
            (a.balance, a.seqNum)
    applied, forged = collections.Counter(), 0
    for (blob,) in txs:
        frame = make_frame(TransactionEnvelope.from_bytes(bytes(blob)),
                           network_id)
        raw = bytes(frame.source_id.value)
        applied[labels.get(raw, "other").split()[0]] += 1
        h = frame.contents_hash()
        if not any(PubKeyUtils.verify_sig(raw, bytes(s.signature), h)
                   for s in frame.signatures):
            forged += 1
    return accounts, dict(applied), forged


def cluster_run(backend, root, accounts=NODE_LOAD, txs=NODE_LOAD,
                rounds=CLUSTER_ROUNDS, cluster_cls=None):
    """Phase 17's three legs on the port's simulation/cluster.py: one
    `python -m stellar_core_tpu_torch run` process per validator of
    Cluster(CLUSTER_ORGS, 1) (four orgs of one, the tiered quorum set,
    real TCP on loopback ports the system hands out, each node's own
    sqlite file and bucket directory), SIGNATURE_VERIFY_BACKEND `backend`
    in every node's configuration, driven only through the admin API
    with the harness's methods as run_cluster_scenario drives its legs.
    Leg 1 (load): node 0's generateload creates `accounts` accounts, then
    `rounds` pay rounds of `txs`, each followed by drain_pending on node
    0 and wait_slot on every node. Leg 2 (bad-signature flood): the
    scenario's chaos leg, the flooder the last node and
    bad_sig_flood_schedule on the honest nodes; the flooder creates and
    pays CLUSTER_FLOOD; then the schedule is cleared and the mesh
    re-knit. Leg 3 (churn): a kill -9 of node 1 while node 0 runs one
    more pay round among the survivors, a restart from its data_dir and
    its catchup over the wire. After each leg the headers of every node
    are compared (headers_agree). Just before the kill: node 1's
    metrics, perf zones, backendstatus and whether the native XDR codec
    serves it (info's xdr_native), under "<name> life 1" (its counters
    die with it). Before the graceful stop: every node's metrics, perf
    zones, chaos status, backendstatus and xdr_native, and each leg's
    clusterstatus close timers. After it: each node's accounts and
    applied transactions from its sqlite file (cluster_ledger).
    `cluster_cls` stands in for Cluster (tests/cluster_mix.py)."""
    from stellar_core_tpu_torch.crypto.sha import sha256
    from stellar_core_tpu_torch.simulation.cluster import (
        POLL_BASE_S, Cluster, ClusterError, bad_sig_flood_schedule)
    c = (cluster_cls or Cluster)(
        CLUSTER_ORGS, 1, root, close_time=CLUSTER_CLOSE_S,
        extra_config={"SIGNATURE_VERIFY_BACKEND": backend,
                      "CONTROLLER_TICK_PERIOD": 0.0})
    nodes = c.nodes
    node0, victim, flooder = nodes[0], nodes[1], nodes[-1]
    honest = nodes[:-1]
    rec = dict(backend=backend, nodes=[n.name for n in nodes],
               flooder=flooder.name, victim=victim.name, rounds=[],
               agree={}, close={}, submitted={})

    def agree(leg):
        upto = c.min_lcl()
        st = c.collect_clusterstatus(30.0, headers=f"2-{upto}")
        rec["agree"][leg] = (upto, c.headers_agree(upto, st,
                                                   expected=len(nodes)))
        rec["close"][leg] = {k: v and v.get("close") for k, v in st.items()}

    def pay_round(leg, among):
        lcl0, t0 = c.lcl(node0), time.perf_counter()
        r = c.generate_load(node0, "pay", txs=txs)
        if not c.drain_pending(node0, 90.0):
            raise ClusterError(f"{leg}: node 0's queue never drained")
        top = c.lcl(node0)
        c.wait_slot(top, 90.0, nodes=among)
        rec["rounds"].append(dict(leg=leg, submitted=int(r["submitted"]),
                                  ledgers=[lcl0, top],
                                  wall_s=time.perf_counter() - t0))

    t_all = time.perf_counter()
    with c:
        c.start_all(CLUSTER_BOOT_S)
        rec["boot_s"] = time.perf_counter() - t_all
        c.wait_mesh(60.0 + 5.0 * len(nodes))
        c.wait_slot(2, 60.0)
        # ---- leg 1: load
        t0 = time.perf_counter()
        rec["submitted"]["create"] = int(c.generate_load(
            node0, "create", accounts=accounts)["submitted"])
        c.wait_slot(c.lcl(node0) + 2, 60.0)
        rec["create_s"] = time.perf_counter() - t0
        for _ in range(rounds):
            pay_round("load", nodes)
        agree("load")
        # ---- leg 2: the bad-signature flood
        t0 = time.perf_counter()
        for node in honest:
            c.install_chaos(node, CLUSTER_CHAOS_SEED, bad_sig_flood_schedule(
                flooder.node_id.hex(), burst=CLUSTER_BURST))
        rec["submitted"]["flood_create"] = int(c.generate_load(
            flooder, "create", accounts=CLUSTER_FLOOD[0])["submitted"])
        c.wait_slot(c.lcl(flooder) + 2, 60.0)
        rec["submitted"]["flood_pay"] = int(c.generate_load(
            flooder, "pay", txs=CLUSTER_FLOOD[1])["submitted"])
        dropped_on, deadline = [], time.monotonic() + 60.0
        while not dropped_on and time.monotonic() < deadline:
            for node in honest:
                try:
                    cs = node.get("clusterstatus", timeout=1.0)
                except (OSError, ValueError, ClusterError):
                    continue
                if cs.get("clusterstatus", {}).get("peers", {}).get(
                        "drop_reasons", {}).get("bad sig flood", 0):
                    dropped_on.append(node.name)
            if not dropped_on:
                honest[0].jittered_sleep(POLL_BASE_S * 3)
        rec["dropped_on"] = dropped_on
        if not c.drain_pending(flooder, 90.0):
            raise ClusterError("flood: the flooder's queue never drained")
        c.wait_slot(c.lcl(flooder), 90.0)
        rec["chaos"] = {n.name: n.get("chaos")["chaos"] for n in honest}
        rec["bad_sig"] = {n.name: n.get("metrics")["metrics"].get(
            "overlay.peer.drop.bad_sig", {}).get("count", 0)
            for n in honest}
        for node in honest:
            c.clear_chaos(node)
        c.wait_mesh(60.0)
        rec["flood_s"] = time.perf_counter() - t0
        agree("flood")
        # ---- leg 3: churn
        t0 = time.perf_counter()
        survivors = [n for n in nodes if n is not victim]
        rec["lcl_at_kill"] = c.lcl(victim)
        life1 = f"{victim.name} life 1"
        rec["metrics"] = {life1: victim.get("metrics")["metrics"]}
        rec["perf"] = {life1: victim.get("perf")["perf"]}
        rec["backend"] = {life1: c.collect_backend(15.0)["per_node"][
            victim.name]}
        rec["codec"] = {life1: victim.get("info")["info"]["xdr_native"]}
        c.kill_node(victim)
        pay_round("churn", survivors)
        c.restart_node(victim, 90.0)
        net = c.min_lcl(survivors)
        rec["caught_up"] = victim.poll(
            "info", deadline=time.monotonic() + 120.0,
            ok=lambda d: d.get("info", {}).get("ledger", {}).get("num", 0)
            >= net) is not None
        rec["network_lcl_at_restart"] = net
        c.wait_mesh(60.0)
        rec["churn_s"] = time.perf_counter() - t0
        agree("churn")
        # ---- sweeps, then a graceful stop
        rec["metrics"].update({n.name: n.get("metrics")["metrics"]
                               for n in nodes})
        rec["perf"].update({n.name: n.get("perf")["perf"] for n in nodes})
        rec["backend"].update(c.collect_backend(15.0)["per_node"])
        rec["codec"].update({n.name: n.get("info")["info"]["xdr_native"]
                             for n in nodes})
        rec["lcl"] = {n.name: c.lcl(n) for n in nodes}
        rec["rcs"] = c.stop_all(graceful=True)
    rec["wall_s"] = time.perf_counter() - t_all
    labels = cluster_labels(c, accounts)
    network_id = sha256(c.passphrase.encode())
    rec["ledger"] = {n.name: cluster_ledger(os.path.join(n.data_dir,
                                                         "node.db"),
                                            labels, network_id)
                     for n in nodes}
    return rec


CLUSTER_STANDALONE = """RUN_STANDALONE = true
MANUAL_CLOSE = true
HTTP_PORT = 0
NETWORK_PASSPHRASE = "Standalone Network ; February 2017"
SIGNATURE_VERIFY_BACKEND = "cuda"
DATABASE = "sqlite3://{dir}/node.db"
BUCKET_DIR_PATH = "{dir}/buckets"
"""


def cluster_self_check(directory):
    """The command line on the card: `python -m stellar_core_tpu_torch
    --conf node.cfg new-db`, then `self-check`, on a standalone node
    whose configuration selects the "cuda" backend. Returns the exit
    code, the report (JSON on standard output) and the wall."""
    conf = os.path.join(directory, "node.cfg")
    with open(conf, "w") as f:
        f.write(CLUSTER_STANDALONE.format(dir=directory))
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "stellar_core_tpu_torch", "--conf", conf]
    res = subprocess.run(cmd + ["new-db"], cwd=root, capture_output=True,
                         text=True, timeout=SPAWN_TIMEOUT_S)
    if res.returncode:
        raise SystemExit(f"cluster: new-db failed: {res.stderr[-2000:]}")
    t0 = time.perf_counter()
    res = subprocess.run(cmd + ["self-check"], cwd=root,
                         capture_output=True, text=True,
                         timeout=SPAWN_TIMEOUT_S)
    wall = time.perf_counter() - t0
    try:
        report = json.loads(res.stdout)
    except ValueError:
        report = {"stdout": res.stdout[-2000:], "stderr": res.stderr[-2000:]}
    return res.returncode, report, wall


def cluster_problems(a, b):
    """Phase 17's verdicts on run A (`a`, the device backend) and run B
    (`b`, native), cluster_run's records. Each node's metrics, perf and
    backend checks cover the victim's first life too. Returns what
    failed."""
    problems = []
    for tag, r in (("A", a), ("B", b)):
        for leg, (upto, ok) in r["agree"].items():
            if not ok:
                problems.append(f"run {tag}: headers disagree after leg "
                                f"{leg} (up to ledger {upto})")
        if not r["caught_up"]:
            problems.append(f"run {tag}: {r['victim']} never caught up")
        if any(rc != 0 for rc in r["rcs"].values()):
            problems.append(f"run {tag}: exit codes {r['rcs']}")
        pays = sum(x["submitted"] for x in r["rounds"])
        states = {n: s[0] for n, s in r["ledger"].items()}
        if any(s != states[r["nodes"][0]] for s in states.values()):
            problems.append(f"run {tag}: the nodes' accounts differ")
        for n, (accounts, applied, forged) in r["ledger"].items():
            load = {k: v for k, v in accounts.items()
                    if k.startswith("load ")}
            if len(load) != r["submitted"]["create"] or \
                    applied.get("load") != pays or \
                    sum(seq & 0xFFFFFFFF for _, seq in load.values()) \
                    != pays:
                problems.append(f"run {tag} {n}: {len(load)} load "
                                f"accounts, {applied.get('load')} load "
                                f"transactions applied of {pays}")
            if forged:
                problems.append(f"run {tag} {n}: {forged} applied "
                                "transactions carry no valid signature")
        if not r["dropped_on"]:
            problems.append(f"run {tag}: no honest node dropped the "
                            "flooder")
        injected = {n: c.get("injected", {}).get(
            "chaos.injected.bad_sig_flood", 0) for n, c in
            r["chaos"].items()}
        if not sum(injected.values()) or any(
                r["bad_sig"][n] != CLUSTER_BURST * k
                for n, k in injected.items()):
            problems.append(f"run {tag}: bad-signature drops "
                            f"{r['bad_sig']} for bursts injected "
                            f"{injected} of {CLUSTER_BURST} twins")
        fallbacks = {n: m.get("crypto.verify_service.fallback",
                              {}).get("count", 0)
                     for n, m in r["metrics"].items()}
        if any(fallbacks.values()):
            problems.append(f"run {tag}: service fallbacks {fallbacks}")
        if not all(r["codec"].values()):
            problems.append(f"run {tag}: the native XDR codec does not "
                            f"serve every node process: {r['codec']}")
    for n, st in a["backend"].items():
        devices = (st or {}).get("devices") or []
        if st is None or st["state"] != "CLOSED" or \
                any(st["failures"].values()) or st["transition_count"] \
                or [d["device"] for d in devices] != [0] or \
                any(d["skips"] or d["state"] != "CLOSED"
                    for d in devices):
            problems.append(f"run A {n}: backend {st}")
    dispatches = cluster_dispatches(a)
    for n, d in dispatches.items():
        occupancy = a["metrics"][n].get(
            "crypto.verify_service.occupancy", {}).get("max", 0)
        if occupancy >= LIVE["device_min_batch"] and not d["count"]:
            problems.append(f"run A {n}: a flush of {occupancy} but "
                            f"{d['count']} device dispatches")
    # every node but node 0 admits node 0's load by flood (the victim in
    # its first life; its second life validates the txsets it missed):
    # each dispatched
    if not all(d["count"] for n, d in dispatches.items()
               if n != a["nodes"][0]):
        problems.append(f"run A: device dispatches {dispatches}")
    if any(v is not None for v in b["backend"].values()):
        problems.append(f"run B: a device backend {b['backend']}")
    if any(d["count"] for d in cluster_dispatches(b).values()):
        problems.append("run B dispatched to a device")
    # the end state: every account but the flooder's, whose payments
    # apply or age out of its queue as its links are dropped, on its
    # balance and the transactions it sent (the seqNum's low 32 bits);
    # two native runs differ on the flooder's accounts and on the ledger
    # each account was created in (the seqNum's high bits:
    # tests/cluster_mix.py)
    kept = [{k: (bal, seq & 0xFFFFFFFF) for k, (bal, seq) in
             next(iter(r["ledger"].values()))[0].items()
             if not k.startswith("flood ")} for r in (a, b)]
    if kept[0] != kept[1]:
        diff = sorted(k for k in set(kept[0]) | set(kept[1])
                      if kept[0].get(k) != kept[1].get(k))
        problems.append(f"runs A and B differ on {len(diff)} accounts, "
                        f"{diff[:5]}")
    return problems


def cluster_dispatches(r):
    """Each node's device dispatches (crypto.verify.dispatch.batch:
    count, sum of rows, largest), their walls from dispatch to
    collected (crypto.verify.dispatch.wall, in ms) from its metrics
    route, and the verifier calls no service flush made (the txset
    prevalidator's: the verifier's device and bypass zones less the
    service's flushes, from its perf route)."""
    out = {}
    for n, m in r["metrics"].items():
        h = m.get("crypto.verify.dispatch.batch") or {}
        w = m.get("crypto.verify.dispatch.wall") or {}
        z = {k: v["count"] for k, v in r["perf"][n].items()}
        out[n] = {"count": h.get("count", 0), "rows": h.get("sum", 0),
                  "max": h.get("max", 0), "median": h.get("median", 0),
                  "wall_ms": {k: round(w[k] * 1e3, 3) for k in
                              ("min", "median", "99%", "max") if k in w},
                  "unflushed": z.get("crypto.batchVerify", 0) // 2
                  + z.get("crypto.batchVerify.native", 0)
                  - z.get("crypto.verifyService.flush", 0)}
    return out


def cluster_phase(card, imad_per_s, accounts=NODE_LOAD,
                  rounds=CLUSTER_ROUNDS):
    """Phase 17: BASELINE.json config #5 across processes on one card
    (see the docstring): the command line's self-check on the card, then
    cluster_run's three legs with SIGNATURE_VERIFY_BACKEND "cuda" (run
    A: each node process builds its own BackendSupervisor(
    CudaBatchVerifier()) and VerifyService on the card) and "native"
    (run B), held to cluster_problems. The node processes load the
    kernel library and the native XDR codec this process built: the
    phase fails if a build directory changes or a node process (either
    life of node 1) reports the codec not serving it. Then both kernels are held against their plain
    versions and timed on as many rows as the largest device dispatch
    any node of run A reports. `accounts` (the payments of each pay
    round too) and `rounds` cut the load's depth (the card's test
    runs it smaller). Returns the device dispatches of run A's node
    processes, both of node 1's lives (one prep, in msg32 or k mode, and
    one ladder each; the metrics do not split the modes), and
    held_kernels' result."""
    from stellar_core_tpu_torch.crypto.keys import SecretKey
    from stellar_core_tpu_torch.ops import _build
    from stellar_core_tpu_torch.xdr import native_codec
    dirs = (_build.BUILD, native_codec._BUILD)
    def listed():
        return [sorted(os.listdir(d)) if os.path.isdir(d) else []
                for d in dirs]
    built = listed()
    work = tempfile.mkdtemp(prefix="cluster-")
    try:
        os.makedirs(os.path.join(work, "self"))
        rc, report, sc_s = cluster_self_check(os.path.join(work, "self"))
        if rc or not report.get("ok") or \
                not report.get("tpu_backend_ok") or \
                not report.get("verify_service_ok"):
            raise SystemExit(f"cluster: self-check on the card exited "
                             f"{rc}: {json.dumps(report)[:2000]}")
        runs = {}
        for tag, backend in (("A", "cuda"), ("B", "native")):
            root = os.path.join(work, tag)
            os.makedirs(root)
            runs[tag] = cluster_run(backend, root, accounts, accounts,
                                    rounds)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    a, b = runs["A"], runs["B"]
    problems = cluster_problems(a, b)
    if listed() != built:
        problems.append(f"the node processes changed a build directory: "
                        f"{built} -> {listed()}")
    if problems:
        raise SystemExit("cluster: " + "; ".join(problems))
    dispatches = cluster_dispatches(a)
    total = sum(d["count"] for d in dispatches.values())
    largest = max(d["max"] for d in dispatches.values())
    keys = [SecretKey.pseudo_random_for_testing(30000 + i)
            for i in range(64)]
    items = []
    for i in range(int(largest)):
        sk, h = keys[i % len(keys)], hashlib.sha256(b"pay-%d" % i).digest()
        items.append((sk.public_key().raw, sk.sign(h), h))
    kernels = held_kernels(items, imad_per_s, "cluster")

    print(f"cluster: {len(a['nodes'])} validator processes of the port's "
          f"simulation/cluster.py (Cluster({CLUSTER_ORGS}, 1), real TCP, "
          f"driven over the admin API); self-check from the command line "
          f"on the card in {sc_s:.3f} s, verify_per_second_tpu_batch "
          f"{report.get('verify_per_second_tpu_batch')}; run A (\"cuda\") "
          f"{a['wall_s']:.3f} s, run B (\"native\") {b['wall_s']:.3f} s "
          f"[{card}]", flush=True)
    for tag, r in (("A", a), ("B", b)):
        print(f"  run {tag}: boot {r['boot_s']:.3f} s, create "
              f"{r['create_s']:.3f} s, flood leg {r['flood_s']:.3f} s, "
              f"churn leg {r['churn_s']:.3f} s; pay rounds (submitted, "
              f"ledgers, wall s): " + ", ".join(
                  f"{x['leg']} {x['submitted']} {x['ledgers']} "
                  f"{x['wall_s']:.3f}" for x in r["rounds"]), flush=True)
        print(f"  run {tag}: headers agree {r['agree']}; flooder "
              f"{r['flooder']} dropped on {r['dropped_on']}; bad-sig "
              f"drops {r['bad_sig']}; bursts injected "
              f"{ {n: c.get('injected', {}) for n, c in r['chaos'].items()} }"
              f"; {r['victim']} killed at ledger {r['lcl_at_kill']}, "
              f"caught up to {r['network_lcl_at_restart']}; LCL "
              f"{r['lcl']}", flush=True)
        for leg, closes in r["close"].items():
            print(f"  run {tag} close timers after leg {leg} (ms): "
                  + json.dumps(closes), flush=True)
    for n, d in dispatches.items():
        m = a["metrics"][n]
        occ = m.get("crypto.verify_service.occupancy") or {}
        zones = {k: v["count"] for k, v in a["perf"][n].items()
                 if k.startswith("crypto.")}
        print(f"  run A {n}: device dispatches {d['count']} (rows "
              f"{d['rows']}, median {d['median']}, largest {d['max']}), "
              f"dispatch to collected (ms) {d['wall_ms']}; service "
              f"flushes {occ.get('count')} (median {occ.get('median')}, "
              f"largest {occ.get('max')}); verifier calls outside the "
              f"service (the txset prevalidator's) {d['unflushed']}; "
              f"zones {zones}; backend "
              f"{json.dumps(a['backend'][n]['devices'])} [{card}]",
              flush=True)
    print(f"cluster: launches in the node processes (their metrics, node "
          f"1's two lives): prep (msg32 or k: the metrics count dispatches, "
          f"not modes) = ladder = {total} device dispatches; every account "
          f"but "
          f"the flooder's equal in runs A and B; no forged twin applied "
          f"[{card}]", flush=True)
    for name, e in kernels.items():
        print(f"cluster {name}[msg32] on the largest dispatch's size, "
              f"n={e['n']}: {e['ms']:.4f} ms (plain {e['plain_ms']:.1f} "
              f"ms, matches; bound {e['bound_ms']:.4f} ms = "
              f"{e['bound_ms'] / e['ms']:.4f} of the time) [{card}]",
              flush=True)
    return total, kernels


# phase 18: the port's profile_catchup at its defaults, replayed three
# times, and cuda_differential orchestrate at its default n
PROFILE_LEDGERS = 64     # ledgers the publisher closes (checkpoint 63)
PROFILE_PAYMENTS = 30    # one-Payment transactions per ledger
PROFILE_TOP = 15         # R1's functions printed by tottime
PROFILE_TIMEOUT_S = 600  # each replay process
DIFFERENTIAL_TIMEOUT_S = 900
# the extension functions of the native XDR codec, as cProfile names them
CODEC_CALLS = ("<built-in method _scxdr.pack>",
               "<built-in method _scxdr.unpack>",
               "<built-in method _scxdr.clone>")


def codec_path():
    """The file of the native XDR codec this process loaded: exits unless
    the codec is live (built, loaded, not fallen back to the Python path
    for good) and its extension is a hashed build in the package's
    native/build directory."""
    from stellar_core_tpu_torch.xdr import native_codec, runtime
    nc, state = runtime._nc(), native_codec.state()
    if nc is None or state is None or state._failed or not state.ok:
        raise SystemExit("the native XDR codec is not live (SC_XDR_NATIVE=0 "
                         "or its build or load failed): the Python path "
                         "serves")
    path = state.ext.__file__
    if os.path.dirname(path) != native_codec._BUILD or \
            not os.path.basename(path).startswith("_scxdr_"):
        raise SystemExit(f"the codec loaded {path}, not a hashed build in "
                         f"{native_codec._BUILD}")
    return path


def profile_publish(directory, payments=PROFILE_PAYMENTS):
    """The port's profile_catchup publisher in this process: an
    Application of get_test_config(instance 0, the script's first
    config, so its node key and hence its headers are the script's) with
    a tmpdir archive at `directory`/archive in its HISTORY, then
    profile_catchup._publish (PROFILE_LEDGERS ledgers of `payments`
    payments). Returns the archive's root, the passphrase and each
    ledger's header hash."""
    from stellar_core_tpu_torch.history.archive import make_tmpdir_archive
    from stellar_core_tpu_torch.main import Application, get_test_config
    from stellar_core_tpu_torch.scripts import profile_catchup
    from stellar_core_tpu_torch.util.timer import ClockMode, VirtualClock
    root = os.path.join(directory, "archive")
    archive = make_tmpdir_archive("bench", root)
    cfg = get_test_config(instance=0)
    cfg.HISTORY = {"bench": {"get": archive.get_cmd, "put": archive.put_cmd}}
    app = Application.create(VirtualClock(ClockMode.VIRTUAL_TIME), cfg)
    app.start()
    lm, hashes = app.ledger_manager, {}
    close = app.manual_close

    def recorded(*args, **kwargs):
        out = close(*args, **kwargs)
        hashes[lm.get_last_closed_ledger_num()] = \
            lm.get_last_closed_ledger_hash().hex()
        return out
    app.manual_close = recorded
    try:
        profile_catchup._publish(app, cfg, PROFILE_LEDGERS, payments)
    finally:
        app.shutdown()
    return root, cfg.NETWORK_PASSPHRASE, hashes


def profile_replay(archive_root, passphrase, out):
    """One replay of phase 18, in a fresh process, as the port's
    profile_catchup replays (get_test_config, MODE_STORES_HISTORY_MISC
    off, the sequential CatchupWork to the archive's last checkpoint under
    cProfile) but with SIGNATURE_VERIFY_BACKEND "cuda": the Application
    builds BackendSupervisor(CudaBatchVerifier()), which the work takes
    (behind a RecordingVerifier) for catchup prevalidation; its fallback
    verify is the package's default_verify, counting its calls. Writes to `out` a JSON
    document (the final state, the LCL, its hash and bucket-list hash,
    the wall, the kernels' launches, each dispatch's size and verdicts
    off the native verifier, the batches' hits and misses, the fallback
    calls, the supervisor's status, whether the codec was live), the
    profile to `out`.prof and the largest dispatch's rows to `out`.npz.
    Returns 0."""
    import cProfile
    from stellar_core_tpu_torch.catchup.catchup_work import (
        CatchupConfiguration, CatchupWork)
    from stellar_core_tpu_torch.crypto.keys import verify_sig_uncached
    from stellar_core_tpu_torch.history.archive import make_tmpdir_archive
    from stellar_core_tpu_torch.main import Application, get_test_config
    from stellar_core_tpu_torch.tx import signature_checker as sigchk
    from stellar_core_tpu_torch.util.timer import ClockMode, VirtualClock
    from stellar_core_tpu_torch.work import run_work_to_completion
    from stellar_core_tpu_torch.xdr import runtime
    archive = make_tmpdir_archive("bench", archive_root)
    cfg = get_test_config()
    cfg.NETWORK_PASSPHRASE = passphrase
    cfg.SIGNATURE_VERIFY_BACKEND = "cuda"
    cfg.MODE_STORES_HISTORY_MISC = False
    app = Application.create(VirtualClock(ClockMode.VIRTUAL_TIME), cfg)
    app.start()
    sup = app.batch_verifier
    rec, fallbacks = RecordingVerifier(sup), []

    def verify(pub, sig, msg):
        fallbacks.append(1)
        return sigchk.default_verify(pub, sig, msg)
    work = CatchupWork(app, archive, CatchupConfiguration(to_ledger=0),
                       verify=verify, batch_verifier=rec)
    try:
        zero_launches()
        prof = cProfile.Profile()
        t0 = time.perf_counter()
        prof.enable()
        final = run_work_to_completion(app, work)
        prof.disable()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        prof.dump_stats(out + ".prof")
        lm = app.ledger_manager
        header = lm.get_last_closed_ledger_header()
        calls = rec.calls
        if calls:
            items = max(calls, key=lambda c: len(c[0]))[0]
            pubs, sigs, msgs = rows(items)
            np.savez(out + ".npz", pubs=pubs, sigs=sigs,
                     msgs=np.array([list(m) for m in msgs], np.uint8))
        st = sup.status()
        doc = dict(
            state=final.name, lcl=lm.get_last_closed_ledger_num(),
            hash=lm.get_last_closed_ledger_hash().hex(),
            bucket_list=bytes(header.bucketListHash).hex(), wall_s=wall,
            launches=launches, dispatches=[len(c[0]) for c in calls],
            off_native=[sum(g != verify_sig_uncached(*t)
                            for t, g in zip(c[0], c[1])) for c in calls],
            batches=work_batches(work, False), fallbacks=len(fallbacks),
            supervisor={k: st[k] for k in (
                "state", "dispatches", "skips", "failures",
                "transition_count")},
            codec=runtime._nc() is not None)
    finally:
        app.shutdown()
    with open(out, "w") as f:
        json.dump(doc, f)
    return 0


def profile_problems(last, hashes, r1, r2, r3, payments):
    """What phase 18's replays got wrong, on whatever device they ran:
    R1, R2 and R3 (profile_runs' documents) not on the publisher's last
    checkpoint `last` with its hash (`hashes`) and R1's bucket-list
    hash; R1 or R2 not ending in success, with other dispatches than one
    of every signature the replayed ledgers hold, verdicts off the native
    verifier, batch misses, fallback calls, a supervisor not CLOSED or
    with failures, skips, transitions or other dispatches; R1 without the
    codec's calls in its profile, R2 with any."""
    p = []
    want = [1 + (last - 2) * payments]
    for tag, r in (("R1", r1), ("R2", r2)):
        if r["state"] != "WORK_SUCCESS":
            p.append(f"{tag} ended {r['state']}")
        if r["dispatches"] != want:
            p.append(f"{tag} dispatched {r['dispatches']}, predicted "
                     f"{want}")
        if any(r["off_native"]) or r["fallbacks"] or \
                any(b["misses"] or b["failed"] or not b["landed"]
                    for b in r["batches"]):
            p.append(f"{tag}: verdicts off native {r['off_native']}, "
                     f"batches {r['batches']}, fallback calls "
                     f"{r['fallbacks']}")
        sup = r["supervisor"]
        if sup["state"] != "CLOSED" or sum(sup["failures"].values()) or \
                sup["skips"] or sup["transition_count"] or \
                sup["dispatches"] != len(r["dispatches"]):
            p.append(f"{tag} supervisor {sup}")
    for tag, r in (("R1", r1), ("R2", r2), ("R3", r3)):
        if r["lcl"] != last or r["hash"] != hashes[last] or \
                r["bucket_list"] != r1["bucket_list"]:
            p.append(f"{tag} landed on {r['lcl']} {r['hash'][:16]} "
                     f"(bucket list {r['bucket_list'][:16]}), not "
                     f"the publisher's {last} {hashes[last][:16]}")
    if not r1["codec"] or not r1["codec_calls"]:
        p.append(f"R1 ran without the codec: {r1['codec_calls']}")
    if r2["codec"] or r2["codec_calls"]:
        p.append(f"R2 ran the codec: {r2['codec_calls']}")
    return p


def codec_calls(prof_path):
    """Calls of the codec's extension functions in a cProfile dump."""
    import pstats
    stats = pstats.Stats(prof_path).stats
    return {name: v[1] for (f, _, name), v in stats.items()
            if f == "~" and name in CODEC_CALLS}


def top_functions(prof_path, n=PROFILE_TOP):
    """The profile's `n` functions with the most own time, as pstats
    prints them."""
    import io
    import pstats
    s = io.StringIO()
    pstats.Stats(prof_path, stream=s).sort_stats("tottime").print_stats(n)
    text = s.getvalue()
    # from the table's header on: the lines above name the dump's file
    return text[text.index("ncalls"):]


def script_replay(payments):
    """R3: `python -m stellar_core_tpu_torch.scripts.profile_catchup
    PROFILE_LEDGERS payments` as it is (its own publisher, the native backend).
    Returns its LCL, wall, rate, LCL hash and bucket-list hash from its
    output."""
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "stellar_core_tpu_torch.scripts."
         "profile_catchup", str(PROFILE_LEDGERS), str(payments)],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=PROFILE_TIMEOUT_S)
    wall = time.perf_counter() - t0
    m = re.search(r"replayed to ledger (\d+) in ([\d.]+)s = ([\d.]+) "
                  r"ledgers/s\nLCL \d+ hash (\w+) bucket list (\w+)",
                  res.stdout)
    if res.returncode or m is None:
        raise SystemExit(f"profile: profile_catchup exited "
                         f"{res.returncode}: {res.stdout[-2000:]} "
                         f"{res.stderr[-2000:]}")
    return dict(lcl=int(m[1]), wall_s=float(m[2]), rate=float(m[3]),
                hash=m[4], bucket_list=m[5], process_s=wall)


def profile_runs(payments=PROFILE_PAYMENTS):
    """Phase 18's replays (see the docstring): profile_publish once, then
    R1 (the "cuda" backend, codec on) and R2 (the same with
    SC_XDR_NATIVE=0), each profile_replay in a fresh process, and R3
    (script_replay). Returns the publisher's last checkpoint, each
    ledger's hash, the three replays' documents (R1's and R2's with their
    codec calls, R1's with its top functions) and R1's largest
    dispatch's rows."""
    work = tempfile.mkdtemp(prefix="profile-")
    here = os.path.dirname(os.path.abspath(__file__))
    items, runs = [], {}
    try:
        t0 = time.perf_counter()
        root, passphrase, hashes = profile_publish(work, payments)
        last = max(h for h in hashes if h % 64 == 63)
        print(f"profile: published {max(hashes)} ledgers of {payments} "
              f"payments in {time.perf_counter() - t0:.3f} s, checkpoint "
              f"{last}", flush=True)
        for tag, extra in (("R1", {}), ("R2", {"SC_XDR_NATIVE": "0"})):
            out = os.path.join(work, f"{tag}.json")
            t0 = time.perf_counter()
            res = subprocess.run(
                [sys.executable, "-c", "import sys, chip_smoke; sys.exit("
                 "chip_smoke.profile_replay(*sys.argv[1:]))", root,
                 passphrase, out], cwd=here,
                env=dict(os.environ, **extra), capture_output=True,
                text=True, timeout=PROFILE_TIMEOUT_S)
            if res.returncode:
                raise SystemExit(f"profile: {tag} exited {res.returncode}: "
                                 f"{res.stderr[-3000:]}")
            with open(out) as f:
                runs[tag] = json.load(f)
            runs[tag]["process_s"] = time.perf_counter() - t0
            runs[tag]["codec_calls"] = codec_calls(out + ".prof")
            if tag == "R1":
                runs[tag]["top"] = top_functions(out + ".prof")
                if os.path.exists(out + ".npz"):
                    z = np.load(out + ".npz")
                    items = [(p.tobytes(), s.tobytes(), m.tobytes())
                             for p, s, m in zip(z["pubs"], z["sigs"],
                                                z["msgs"])]
        runs["R3"] = script_replay(payments)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return last, hashes, (runs["R1"], runs["R2"], runs["R3"]), items


def profile_phase(card, imad_per_s, payments=PROFILE_PAYMENTS):
    """Phase 18's replays on the card: profile_runs, held to
    profile_problems and to one prep msg32 and one ladder launch per
    dispatch in R1 and R2; then both kernels are held against their
    plain versions on R1's largest dispatch. `payments` cuts the load
    (the card's test runs it smaller). Returns the launches of R1 + R2
    and held_kernels' result."""
    last, hashes, (r1, r2, r3), items = profile_runs(payments)
    problems = profile_problems(last, hashes, r1, r2, r3, payments)
    for tag, r in (("R1", r1), ("R2", r2)):
        n = len(r["dispatches"])
        if r["launches"] != {"msg32": n, "k": 0, "ladder": n}:
            problems.append(f"{tag} launches {r['launches']} for {n} "
                            "dispatches")
    if problems:
        raise SystemExit("profile: " + "; ".join(problems))
    for tag, r in (("R1", r1), ("R2", r2)):
        print(f"  {tag} (\"cuda\", codec {'on' if r['codec'] else 'off'}, "
              f"under cProfile): LCL {r['lcl']} {r['hash'][:16]} in "
              f"{r['wall_s']:.3f} s, {(r['lcl'] - 1) / r['wall_s']:.2f} "
              f"replayed ledgers/s ({r['lcl'] / r['wall_s']:.2f} as "
              f"profile_catchup counts); dispatches {r['dispatches']}, "
              f"launches {r['launches']}, supervisor {r['supervisor']}, "
              f"fallback calls {r['fallbacks']}; codec calls "
              f"{r['codec_calls']}; process {r['process_s']:.1f} s "
              f"[{card}]", flush=True)
    print(f"  R3 (profile_catchup {PROFILE_LEDGERS} {payments}, \"native\", "
          f"codec on, under cProfile): LCL {r3['lcl']} {r3['hash'][:16]} "
          f"in {r3['wall_s']:.2f} s = {r3['rate']:.1f} ledgers/s as it "
          f"counts (LCL / wall); process {r3['process_s']:.1f} s with its "
          f"publish [{card}]", flush=True)
    print(f"  R1's top {PROFILE_TOP} functions by tottime:\n"
          + "\n".join("    " + line for line in r1["top"].splitlines()
                      if line.strip()), flush=True)
    launches = {k: r1["launches"][k] + r2["launches"][k]
                for k in r1["launches"]}
    held = held_kernels(items, imad_per_s, "profile")
    print(f"  held on R1's largest dispatch (n={len(items)}): prep "
          f"{held['prep']['ms']:.4f} ms (plain "
          f"{held['prep']['plain_ms']:.1f} ms), ladder "
          f"{held['ladder']['ms']:.4f} ms (plain "
          f"{held['ladder']['plain_ms']:.1f} ms), equal to plain "
          f"[{card}]", flush=True)
    return launches, held


def differential_phase(card):
    """Phase 18's differential: `python -m stellar_core_tpu_torch.scripts.
    cuda_differential orchestrate` at its default n (10,000 plus the
    adversarial tail) in its own processes, the card and the CPU's plain
    versions at once, each against the oracle and against each other.
    Fails unless it exits 0 with its PASS line. Returns the card run's
    launches."""
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "stellar_core_tpu_torch.scripts."
         "cuda_differential", "orchestrate"],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=DIFFERENTIAL_TIMEOUT_S)
    wall = time.perf_counter() - t0
    docs = [json.loads(line) for line in res.stdout.splitlines()
            if line.startswith("{")]
    card_run = [d for d in docs if d["device"].startswith("cuda")]
    if res.returncode or "CUDA DIFFERENTIAL: PASS" not in res.stdout or \
            len(card_run) != 1:
        raise SystemExit(f"differential: exited {res.returncode}: "
                         f"{res.stdout[-3000:]} {res.stderr[-3000:]}")
    for d in docs:
        print(f"  differential {d['device']}: n={d['n']}, mismatches "
              f"against the oracle {d['mismatches_vs_oracle']}, verify "
              f"{d['secs']} s, launches {d['launches']}", flush=True)
    print(f"differential: card == CPU == oracle on {card_run[0]['n']} "
          f"signatures in {wall:.1f} s [{card}]", flush=True)
    return card_run[0]["launches"]


def cpu_model():
    """The host's CPU from /proc/cpuinfo: its model name, vendor, family
    and model numbers (a virtual machine may name no model)."""
    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                fields.setdefault(key.strip(), value.strip())
    except OSError:
        return "not readable"
    return (f"{fields.get('model name')} ({fields.get('vendor_id')}, family "
            f"{fields.get('cpu family')} model {fields.get('model')})")


def native_baseline(card, sets):
    """Phase 18's native baseline: NativeLib.batch_verify (the reference's
    CPU batch verifier, one thread) on each set of msg32 rows in `sets`
    ({name: (pubs, sigs, msgs, the card's verdicts)}), and the same call
    split over os.cpu_count() threads (ctypes releases the GIL). Fails
    unless every verdict equals the card's. Prints verifies per second
    beside the host's cores and CPU model and the card. A record for a
    benchmark, not a claim."""
    from concurrent.futures import ThreadPoolExecutor

    from stellar_core_tpu_torch.native.loader import get_lib
    lib = get_lib()
    cores = os.cpu_count() or 1
    out = {}
    for name, (pubs, sigs, msgs, want) in sets.items():
        n = len(msgs)
        blob = b"".join(msgs)
        offsets = np.arange(n + 1, dtype=np.uint64) * 32

        def chunk(lo, hi):
            return lib.batch_verify(pubs[lo:hi], sigs[lo:hi],
                                    blob[32 * lo:32 * hi],
                                    offsets[lo:hi + 1] - offsets[lo])
        t0 = time.perf_counter()
        got = chunk(0, n)
        one = time.perf_counter() - t0
        step = -(-n // cores)
        with ThreadPoolExecutor(cores) as pool:
            t0 = time.perf_counter()
            parts = list(pool.map(lambda lo: chunk(lo, min(n, lo + step)),
                                  range(0, n, step)))
            every = time.perf_counter() - t0
        split = np.concatenate(parts)
        if got.tolist() != list(want) or split.tolist() != list(want):
            raise SystemExit(f"native baseline on {name}: "
                             f"{sum(g != w for g, w in zip(got, want))} "
                             "verdicts off the card's")
        out[name] = dict(n=n, one_thread=n / one, threads=n / every)
        print(f"native baseline, {name}: batch_verify {n} rows, "
              f"{int(sum(want))} valid, equal to the card: "
              f"{n / one:.1f} verifies/s on one thread, {n / every:.1f} on "
              f"{cores} threads; host {cores} cores, {cpu_model()} "
              f"[{card}]", flush=True)
    return out


def peak_rss(phase, started):
    """Print the process's peak resident set size (getrusage's
    ru_maxrss, KiB on Linux) once phase `phase` has passed."""
    import resource
    kib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    print(f"peak RSS after phase {phase}: {kib / 1024:.1f} MiB at "
          f"{time.perf_counter() - started:.1f} s", flush=True)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    started = time.perf_counter()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from stellar_core_tpu_torch.crypto import ed25519_ref as ref
    from stellar_core_tpu_torch.crypto.keys import SecretKey
    from stellar_core_tpu_torch.ops import _build
    from stellar_core_tpu_torch.ops import ed25519_kernel as EK
    from stellar_core_tpu_torch.ops import ladder as LD
    from stellar_core_tpu_torch.ops.testvectors import (
        make_differential_vectors, oracle_results, small_order_points)
    from stellar_core_tpu_torch.ops.verifier import (CudaBatchVerifier,
                                                     host_k, host_prepare)

    # --- 1. the card -----------------------------------------------------
    card = smi("name,power.limit")
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"card: {card}; max SM clock {clock_mhz} MHz; {sms} SMs")
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    imad_per_s = sms * IMAD_PER_SM_CLK * clock_mhz * 1e6

    # --- the live path's tuples; their oracle verdicts in worker
    # processes while the kernels build ---------------------------------
    t0 = time.perf_counter()
    live_items = live_tuples(SecretKey, LIVE_N)
    print(f"signed {LIVE_N} live tuples in {time.perf_counter() - t0:.1f} s",
          flush=True)
    pool = multiprocessing.get_context("spawn").Pool(
        max(1, min(7, (os.cpu_count() or 2) - 1)))
    atexit.register(pool.terminate)
    live_oracle = pool.starmap_async(ref.verify, live_items, chunksize=256)

    # --- 2. build: constructing a verifier on the card builds the kernels
    if _build._lib is not None:
        raise SystemExit("the kernel library loaded before any verifier")
    t0 = time.perf_counter()
    CudaBatchVerifier()
    if _build._lib is None:
        raise SystemExit("CudaBatchVerifier() on the card did not load the "
                         "kernel library")
    print(f"build (in CudaBatchVerifier()): "
          f"{time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.info['seconds']:.1f} s) -> "
          f"{os.path.relpath(_build.info['path'])}")
    for line in _build.info["ptxas"].splitlines():
        if "Compiling entry" in line or "registers" in line \
                or "spill" in line:
            print("  ptxas:", line.strip())
    mix = sass_mix(_build.info["path"], _build._nvcc())
    if mix is None:
        print("  sass: cuobjdump not found beside nvcc (not measured)")
    for fn, ops in sorted((mix or {}).items()):
        def count(*prefixes):
            return sum(c for op, c in ops.items() if op.startswith(prefixes))
        print(f"  sass {fn}: {sum(ops.values())} instructions, IMAD.WIDE "
              f"{count('IMAD.WIDE')}, IMAD {ops['IMAD']}, SHFL "
              f"{count('SHFL')}, LDS {count('LDS')}, LDL/STL "
              f"{count('LDL', 'STL')}; top {ops.most_common(6)}")
    # the native XDR codec, built (or loaded) here: every phase from 5 on
    # packs, unpacks and clones through it, and phase 17's node processes
    # find this build
    t0 = time.perf_counter()
    codec = codec_path()
    print(f"native XDR codec: live, {os.path.relpath(codec)} (built or "
          f"loaded in {time.perf_counter() - t0:.1f} s)", flush=True)
    infos = {k: geometry(_build.kernel_info(k), N, sms)
             for k in _build.KERNELS}
    for k, info in infos.items():
        print(f"  {k}: {info}")
    sys.stdout.flush()

    # --- signed tuples for phases 3 and 5 --------------------------------
    t0 = time.perf_counter()
    keys = [SecretKey.pseudo_random_for_testing(9000 + i) for i in range(64)]
    distinct = []
    for i in range(DISTINCT):
        sk = keys[i % len(keys)]
        msg = (b"chip-smoke-%d" % i).ljust(32, b".")
        distinct.append((sk.public_key().raw, sk.sign(msg), msg))
    print(f"signed {DISTINCT} distinct tuples in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    distinct_oracle = pool.starmap_async(ref.verify, distinct)
    pubs, sigs, msgs = rows([distinct[i % DISTINCT] for i in range(N)])

    # --- 3. kernels against their plain versions, n = 16384 --------------
    # every 4th lane is one the strict checks reject or the equation
    # fails: the corpus's 32-byte-message tuples (S >= L, non-canonical,
    # small-order and torsion-defect A and R, corrupted bytes) and random
    # bytes (A that does not decompress, S below 2^252 or random)
    rng = np.random.default_rng(7)
    corpus = make_differential_vectors(200)
    bad = [t for t in corpus if len(t[2]) == 32]
    for j in range(256):
        b = rng.integers(0, 256, 128, dtype=np.uint8).tobytes()
        s_ = b[64:96] if j % 2 else b[64:95] + bytes([b[95] & 0x0F])
        bad.append((b[:32], b[32:64] + s_, b[96:]))
    lanes = [bad[(i // 4) % len(bad)] if i % 4 == 3
             else distinct[i % DISTINCT] for i in range(N)]
    t0 = time.perf_counter()
    torsion_y = {int.from_bytes(t, "little") & ((1 << 255) - 1)
                 for t in small_order_points()}
    uniq = {t: (strict_flags(ref, torsion_y, t[0], t[1]), ref.verify(*t))
            for t in set(lanes)}
    want_ok = torch.tensor([uniq[t][0] for t in lanes], dtype=torch.uint8,
                           device=dev)
    want_verdict = [uniq[t][1] for t in lanes]
    print(f"phase 3 lanes: {len(uniq)} distinct, {int(want_ok.sum())} of "
          f"{N} pass the strict checks, {sum(want_verdict)} verify "
          f"(oracle, {time.perf_counter() - t0:.1f} s)", flush=True)
    p3, s3, m3 = rows(lanes)

    def dev_u8(arr):
        return torch.from_numpy(np.array(arr)).to(dev)

    a, r, s = dev_u8(p3), dev_u8(s3[:, :32]), dev_u8(s3[:, 32:])
    m = dev_u8(np.frombuffer(b"".join(m3), np.uint8).reshape(N, 32))
    k_host = dev_u8(host_k(p3, s3, m3))
    entries = []
    for mode, mk, tag in ((EK.MODE_MSG32, m, "msg32"),
                          (EK.MODE_K, k_host, "k")):
        got = EK.prep(a, r, s, mk, mode)
        want, plain_ms = once_ms(lambda: EK.prep_plain(a, r, s, mk, mode))
        match = all(torch.equal(x, y) for x, y in zip(got, want))
        ms = median_ms(lambda: EK.prep(a, r, s, mk, mode))
        # prep's work does not depend on the data: its schedule is the
        # fewest products the function needs
        products = N * EK.prep_products(mode)
        bytes_ = N * (128 + 32 + 64 + 1)
        b_ops = products / imad_per_s * 1e3
        b_mem = bytes_ / HBM_BYTES_PER_S * 1e3
        entries.append(dict(
            name=f"ed25519_prep[{tag}]", route="cuda",
            source="stellar_core_tpu_torch/ops/csrc/ed25519.cu",
            replaces=("stellar_core_tpu/ops/sha512.py:129 sha512_96, :240 "
                      "mod_l, ed25519_kernel.py:305 decompress_neg, :357 "
                      "_verify_full flags"),
            n=N, match=match, max_abs_err=max_abs_err(got, want),
            ms=ms, plain_ms=plain_ms, bound_ms=max(b_ops, b_mem),
            bound_by="operations" if b_ops >= b_mem else "bytes",
            library_ms=None, launches=None,
            bound_products_per_sig=products / N,
            bound_share=max(b_ops, b_mem) / ms, **infos["ed25519_prep"]))
        if not match:
            raise SystemExit(f"ed25519_prep[{tag}] disagrees with plain")
        print(f"prep[{tag}] matches plain at n={N}: {ms:.4f} ms "
              f"(plain {plain_ms:.1f} ms; bound {max(b_ops, b_mem):.4f} ms "
              f"= {max(b_ops, b_mem) / ms:.4f} of the time; the bound "
              f"counts {products / N:.0f} products per signature; "
              f"{describe(infos['ed25519_prep'])})",
              flush=True)
        if not torch.equal(got[2], want_ok):
            raise SystemExit(f"prep[{tag}] ok flags differ from the "
                             "oracle's strict checks")
        if mode == EK.MODE_MSG32:
            k_dev, neg_a, ok = got
            if not torch.equal(k_dev, k_host):
                raise SystemExit("device k differs from host k")
    nax, nay = neg_a[:, :32].contiguous(), neg_a[:, 32:].contiguous()
    got = LD.ladder(s, k_dev, nax, nay)
    want, plain_ms = once_ms(lambda: LD.ladder_plain(s, k_dev, nax, nay))
    match = all(torch.equal(x, y) for x, y in zip(got, want))
    ms = median_ms(lambda: LD.ladder(s, k_dev, nax, nay))
    s_np, k_np = s.cpu().numpy().tobytes(), k_dev.cpu().numpy().tobytes()
    products = ladder_products(
        [s_np[32 * i:32 * i + 32] for i in range(N)],
        [k_np[32 * i:32 * i + 32] for i in range(N)])
    b_ops = products / imad_per_s * 1e3
    b_mem = N * (4 * 32 + 2 * 32) / HBM_BYTES_PER_S * 1e3
    entries.append(dict(
        name="ed25519_ladder", route="cuda",
        source="stellar_core_tpu_torch/ops/csrc/ed25519.cu",
        replaces="stellar_core_tpu/ops/ed25519_pallas.py:202 ladder",
        n=N, match=match, max_abs_err=max_abs_err(got, want),
        ms=ms, plain_ms=plain_ms, bound_ms=max(b_ops, b_mem),
        bound_by="operations" if b_ops >= b_mem else "bytes",
        library_ms=None, launches=None,
        bound_products_per_sig=products / N,
        bound_share=max(b_ops, b_mem) / ms,
        **infos["ed25519_ladder"]))
    if not match:
        raise SystemExit("ed25519_ladder disagrees with plain")
    print(f"ladder matches plain at n={N}: {ms:.4f} ms "
          f"(plain {plain_ms:.1f} ms; bound {max(b_ops, b_mem):.4f} ms = "
          f"{max(b_ops, b_mem) / ms:.4f} of the time; the bound counts "
          f"{products / N:.0f} products per signature; "
          f"{describe(infos['ed25519_ladder'])})",
          flush=True)
    print(f"schedule products per signature (static counts of the plain "
          f"versions' schedules, which tests/test_torch_ladder.py::"
          f"test_plain_ladder_matches_oracle_on_edge_scalars and "
          f"tests/test_torch_field.py::test_prep_runs_its_product_count "
          f"check by counting field products; not measured in this run): "
          f"ladder {LD.LADDER_PRODUCTS}, prep[msg32] "
          f"{EK.prep_products(EK.MODE_MSG32)}, prep[k] "
          f"{EK.prep_products(EK.MODE_K)}", flush=True)
    verdict = EK.finish(got[0], got[1], r, ok).cpu().tolist()
    bad_lanes = sum(g != w for g, w in zip(verdict, want_verdict))
    if bad_lanes:
        raise SystemExit(f"prep -> ladder -> finish: {bad_lanes} lanes "
                         "differ from the oracle")
    print(f"prep -> ladder -> finish at n={N}: 0 lanes differ from the "
          "oracle", flush=True)
    # the v1 entry (ed25519_pallas.verify_kernel_pallas): k and -A
    # prepared on the host, the ladder, the compare; the host's flags
    # ANDed, as the reference's callers do
    k1, na1, ok1 = host_prepare(p3[:V1_N], s3[:V1_N], m3[:V1_N])
    got1 = EK.verify_kernel(s[:V1_N], dev_u8(k1), dev_u8(na1[:, :32]),
                            dev_u8(na1[:, 32:]), r[:V1_N])
    got1 = (got1.cpu() & torch.from_numpy(ok1)).tolist()
    bad_lanes = sum(g != w for g, w in zip(got1, want_verdict[:V1_N]))
    if bad_lanes:
        raise SystemExit(f"v1 entry (host_prepare -> verify_kernel): "
                         f"{bad_lanes} lanes differ from the oracle")
    print(f"v1 entry (host_prepare -> verify_kernel) at n={V1_N}: "
          f"{sum(got1)} verify, 0 lanes differ from the oracle", flush=True)

    # --- 4. differential corpus ------------------------------------------
    items = corpus
    want = oracle_results(items)
    for sha in (True, False):
        got = CudaBatchVerifier(device_sha=sha).verify_tuples(items)
        mism = sum(g != w for g, w in zip(got, want))
        print(f"corpus device_sha={sha}: n={len(items)} "
              f"mismatches={mism}", flush=True)
        if mism:
            raise SystemExit("corpus mismatch against the oracle")

    # --- 5. main path at width -------------------------------------------
    v = CudaBatchVerifier()
    if not v.verify_batch(pubs, sigs, msgs).all():           # warm-up
        raise SystemExit("warm-up dispatch rejected a valid signature")
    EK.prep.launches = LD.ladder.launches = 0
    rates = []
    dispatches = 0
    for _ in range(ROUNDS):
        t0 = time.perf_counter()
        handles = [v.verify_batch_async(pubs, sigs, msgs)
                   for _ in range(IN_FLIGHT)]
        results = [h() for h in handles]
        dt = time.perf_counter() - t0
        dispatches += IN_FLIGHT
        if not all(res.all() for res in results):
            raise SystemExit("a valid signature was rejected")
        rates.append(IN_FLIGHT * N / dt)
    t0 = time.perf_counter()
    res = v.verify_batch(pubs[:5000], sigs[:5000], msgs[:5000])
    dt5000 = time.perf_counter() - t0
    dispatches += 1
    if not res.all():
        raise SystemExit("5000 dispatch rejected a valid signature")
    msg32_launches = (EK.prep.launches, LD.ladder.launches)
    if msg32_launches != (dispatches, dispatches):
        raise SystemExit(f"launch counts {msg32_launches} != {dispatches}")
    print(f"msg32: {IN_FLIGHT} x {N} in flight, verifies/s per round "
          f"{[round(x, 1) for x in rates]}; 5000 in {dt5000 * 1e3:.2f} ms "
          f"[{card}]", flush=True)

    lengths = (0, 1, 31, 32, 33, 100, 1000)
    mixed = []
    for i in range(256):
        sk = keys[i % len(keys)]
        msg = bytes((i + j) & 0xFF for j in range(lengths[i % 7]))
        mixed.append((sk.public_key().raw, sk.sign(msg), msg))
    batch = []
    for i in range(2048):
        p_, s_, m_ = mixed[i % len(mixed)]
        if i % 10 == 0:
            s_ = s_[:40] + bytes([s_[40] ^ (1 + i % 7)]) + s_[41:]
        batch.append((p_, s_, m_))
    uniq = {t: ref.verify(*t) for t in set(batch)}
    EK.prep.launches = LD.ladder.launches = 0
    t0 = time.perf_counter()
    got = v.verify_tuples(batch)
    dt_k = time.perf_counter() - t0
    k_launches = (EK.prep.launches, LD.ladder.launches)
    if k_launches != (1, 1):
        raise SystemExit(f"host-k launch counts {k_launches} != (1, 1)")
    bad = sum(g != uniq[t] for g, t in zip(got, batch))
    if bad or sum(got) != 2048 - 205:
        raise SystemExit(f"host-k batch: {bad} mismatches, {sum(got)} ok")
    print(f"host-k: 2048 mixed lengths, every 10th corrupted, 0 mismatches, "
          f"{dt_k * 1e3:.1f} ms", flush=True)
    batch_want, batch_got = [uniq[t] for t in batch], got

    print(f"launch counts: msg32 part {dispatches} dispatches -> prep "
          f"{msg32_launches[0]}, ladder {msg32_launches[1]}; host-k part 1 "
          f"dispatch -> prep {k_launches[0]}, ladder {k_launches[1]}")

    # --- 6. where the time goes: one in-flight round under the profiler --
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()

    def profiled_round():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            handles = [v.verify_batch_async(pubs, sigs, msgs)
                       for _ in range(IN_FLIGHT)]
            for h in handles:
                h()
            wall_ms = (time.perf_counter() - t0) * 1e3
        return prof, wall_ms

    # a warm-up round under the profiler first: tracing's own start-up
    # lands there, not in the measured round
    profiled_round()
    prof, wall_ms = profiled_round()
    by_name = device_ms_by_name(prof)
    busy_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    if busy_ms:
        print(f"profile ({IN_FLIGHT} x {N} in flight, profiler on): wall "
              f"{wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, idle share "
              f"{1 - busy_ms / wall_ms:.4f}")
        for name, ms_ in top:
            print(f"  device {ms_:9.3f} ms  {name[:90]}")
    else:
        print("profile: the profiler saw no device time (not measured)")

    # --- 7. the live verify path -----------------------------------------
    t0 = time.perf_counter()
    live_want = live_oracle.get(timeout=900)
    distinct_want = distinct_oracle.get(timeout=900)
    pool.close()
    pool.join()
    print(f"live oracle verdicts ready ({time.perf_counter() - t0:.1f} s "
          f"more wait): {sum(live_want)} of {LIVE_N} verify", flush=True)
    live, live_rates = live_phase(card, live_items, live_want)
    if not (live["msg32"] + live["k"] and live["ladder"]):
        raise SystemExit(f"live path launched a kernel no time: {live}")

    # --- 8. the multi-device verify path --------------------------------
    mesh = mesh_phase(card, dev, v, (pubs, sigs, msgs),
                      [distinct_want[i % DISTINCT] for i in range(N)],
                      batch, batch_want, batch_got, live_items, live_want)

    # --- 9. txset validation on the card --------------------------------
    txset = txset_phase(card)

    # --- 10. the classic operation families on the card's txset path ---
    classic = classic_phase(card)

    # --- 11. contract auth-entry signatures batched on the card ---------
    soroban = soroban_phase(card)

    # --- 12. wasm contracts on the card's txset path --------------------
    wasm = wasm_phase(card)
    peak_rss(12, started)

    # --- 13. persistence and ledger close, the stage prewarm on the card -
    close = close_phase(card)
    peak_rss(13, started)

    # --- 14. catchup, each checkpoint's signatures in one dispatch -------
    catchup, catchup_times = catchup_phase(card, imad_per_s)
    peak_rss(14, started)

    # --- 15. consensus and flood admission, four validators -------------
    consensus, consensus_times = consensus_phase(card, imad_per_s)
    peak_rss(15, started)

    # --- 16. the node: four Applications over the overlay's loopback -----
    node, node_times = node_phase(card, imad_per_s)
    peak_rss(16, started)

    # --- 17. config #5 across processes: four node processes over TCP --
    cluster, cluster_times = cluster_phase(card, imad_per_s)
    peak_rss(17, started)

    # --- 18. the host tools on the card: the codec, the profiled replays,
    # the differential, the native baseline -------------------------------
    t18 = time.perf_counter()
    if codec_path() != codec:
        raise SystemExit("the native XDR codec changed during the run")
    print(f"native XDR codec still live after phases 5-17: "
          f"{os.path.relpath(codec)}", flush=True)
    profile, profile_times = profile_phase(card, imad_per_s)
    differential = differential_phase(card)
    native_baseline(card, {
        "phase 5's rows": (pubs, sigs, msgs, np.asarray(results[0])),
        "phase 3's lanes": (p3, s3, m3, verdict)})
    print(f"phase 18 in {time.perf_counter() - t18:.1f} s [{card}]",
          flush=True)
    peak_rss(18, started)

    # launches on the main paths, each counted from 0: phase 5 (the
    # verifier at width), legs A and B of phase 7 (the live path), phase 8
    # (the sharded and hybrid verifiers), run A of phase 9 (txset), run A
    # of phase 10 (classic), run A of phase 11 (soroban), run A of
    # phase 12 (wasm), run A of phase 13 (close), runs A1 and A2 of
    # phase 14 (catchup), run A of phase 15 (consensus), run A of
    # phase 16 with node 0's self_check (node) and the node processes of
    # phase 17's run A, by their device dispatches (cluster: the ladder's
    # by path, the prep's unsplit by mode beside its rows)
    verifier = {"msg32": msg32_launches[0], "k": k_launches[0],
                "ladder": msg32_launches[1] + k_launches[1]}
    for e, kind in zip(entries, ("msg32", "k", "ladder")):
        e["launches_by_path"] = {
            "verifier": verifier[kind], "live": live[kind],
            "sharded": mesh["sharded"].get(kind, 0),
            "hybrid": mesh["hybrid"].get(kind, 0),
            "txset": txset[kind], "classic": classic[kind],
            "soroban": soroban[kind], "wasm": wasm[kind],
            "close": close[kind], "catchup": catchup[kind],
            "consensus": consensus[kind], "node": node[kind],
            "profile": profile[kind], "differential": differential[kind]}
        if kind == "ladder":
            e["launches_by_path"]["cluster"] = cluster
        else:
            e["cluster_prep_either_mode"] = cluster
        e["launches"] = sum(e["launches_by_path"].values())
        held = {"msg32": "prep", "ladder": "ladder"}.get(kind)
        if held:
            # the same kernel on the largest catchup dispatch's rows, on
            # one flood burst's rows, on the node's first flush whose
            # size is not a multiple of 32, on as many rows as the
            # cluster's largest dispatch and on R1's largest dispatch
            for path, times in (("catchup", catchup_times),
                                ("consensus", consensus_times),
                                ("node", node_times),
                                ("cluster", cluster_times),
                                ("profile", profile_times)):
                e[path] = {k: times[held][k] for k in (
                    "n", "ms", "plain_ms", "bound_ms", "bound_by",
                    "max_abs_err")}
            print(f"{e['name']}: {e['ms']:.4f} ms at n={e['n']} (phase 3), "
                  f"{e['catchup']['ms']:.4f} ms at n={e['catchup']['n']} "
                  f"(phase 14), {e['consensus']['ms']:.4f} ms at "
                  f"n={e['consensus']['n']} (phase 15), "
                  f"{e['node']['ms']:.4f} ms at n={e['node']['n']} "
                  f"(phase 16), {e['cluster']['ms']:.4f} ms at "
                  f"n={e['cluster']['n']} (phase 17), "
                  f"{e['profile']['ms']:.4f} ms at n={e['profile']['n']} "
                  f"(phase 18) [{card}]", flush=True)
    for path, count in (("sharded", mesh["sharded"]),
                        ("hybrid", mesh["hybrid"])):
        if not (count.get("msg32", 0) + count.get("k", 0)
                and count.get("ladder", 0)):
            raise SystemExit(f"{path} path launched a kernel no time: "
                             f"{count}")
    print(f"chip_smoke: phases 1-18 in {time.perf_counter() - started:.1f} s "
          f"[{card}]", flush=True)
    print(json.dumps({"kernels": entries, "verifies_per_s": rates,
                      "live": live_rates, "card": card}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
