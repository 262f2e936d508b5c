"""Drive the PyTorch port on one NVIDIA GPU: build its CUDA kernels, hold
each against its plain PyTorch version at the main path's shapes, load
TPC-H lineitem through `SnappySession.insert_arrays`, answer Q1 and Q6
through `SnappySession.sql` with both kernel lanes on, then again through
the compressed-domain entry points (`utils/tpch_code_domain`), run the
run-space RLE probe, then load orders and answer TPC-H Q3C (orders LEFT
JOIN lineitem) and a generic-key join through the device join engine,
then stream Q1 and Q6 through the tiled out-of-core lane, answer Q1 and
Q6 over exact DECIMAL(15,2) columns, run count(DISTINCT) and the matmul
reduction strategy, then TPC-H Q4, Q22 and Q18 (subqueries) and a GROUP
BY over scalar and string functions, then window functions over orders,
then UPDATE / DELETE / insert on lineitem under a pinned reader with Q1
and Q6 through both kernels, concurrent scans and ingest, and row tables
(TPC-H Q10 over nation, PUT INTO, get), then nested orders with ARRAY /
MAP / STRUCT columns, then a durable lineitem through the WAL, a
checkpoint, crash-shape recovery and the compactor, then, on that
durable lineitem, the resource governor (ledger, admission, degradation,
cancellation), the HBM -> host -> disk tier ladder with a healed tier
file, a seeded fault storm and the broker-kicked compactor; on the main
session, prepared statements and the micro-batcher, the group-index
cache, a secondary index and a row-level policy, then EXPLAIN [ANALYZE],
request tracing, grants and the stats service, then the front doors
(Arrow Flight, Flight SQL, REST and the client) over that session, then
membership and the CLI, then AQP over a sample table, then stream tables
fed by micro-batches, then a distributed session over two data-server
processes; right after the join path, lineitem and orders on a 4-slot
mesh of the one card (Q1, Q6 and Q3C through the per-slot lane, a live
resize), then the TPC-DS kit's star schema at SF 10 and its eight
reporting queries.

    python3 chip_smoke.py [--sf 16] [--seed 7] [--reps 3] [--profile]
                          [--ptxas] [--tpcds-sf 10] [--tpcds-only]
    python3 chip_smoke.py --load-only [--sf 4] [--tree DIR]

With --profile, each timed query also runs once under torch.profiler
(each session opens with spin kernels that are left out of its figures,
`profile_run`); every breakdown prints the device's kernel records
beside the host's CUDA runtime launch records, which are equal when the
trace kept every kernel (--trace-dir DIR keeps the traces that did not).

Phases, in order; any failure exits non-zero before the result lines:

1. the card's name and power limit (nvidia-smi);
2. build every kernel with nvcc for sm_90a, one process per source,
   all started together and running on through phase 3 (with --ptxas,
   also print ptxas's registers, shared memory and spills of every
   kernel; `build_s` once they end, before phase 4), and the native
   string encoder with g++ (`snappydata_tpu_torch.native`), which must
   load;
3. generate lineitem at scale factor --sf (6M rows per unit) and load it
   (its string columns through the native encoder; rows/s);
4. the main path: launch counters set to 0, Q1 and Q6 through
   `session.sql` with `pallas_group_reduce` and `pallas_reduce` on, the
   counters read back — each kernel must have launched; the inputs each
   kernel received are kept for phase 5;
5. each kernel against its plain version on those inputs (tolerance: the
   compensated sums within 1e-6 * sum(|v|), counts and min/max exact),
   timed beside its bound and one PyTorch library call; the grouped
   kernel's launch configuration (threads, blocks, resident blocks per
   SM, words per group and thread) and its op count before and after
   dedup.  The Kahan kernel also: two calls bit-identical, `ms` over
   back-to-back calls between two events (so host dispatch counts) and
   its launch configuration;
6. the answers: Q1 and Q6 against a float64 numpy oracle computed from the
   generated arrays, and against the same queries with the knobs off
   (counts exact, same-sign sums within rel 1e-6);
7. the compressed-domain path: launch counters set to 0, `code_domain_q6`
   and `code_domain_q1` over the loaded table, the counters read back —
   both code kernels must have launched; counts equal the session's own,
   sums within rel 5e-5 of the session's Q6 / Q1 and of the oracle;
8. each code kernel against its plain version on the inputs phase 7
   handed it (counts exact, sums within 1e-6 * sum(|v|)), timed beside its
   bound and one PyTorch library call, with the launch configuration and
   slot count before and after dedup as in phase 5;
9. the run-space RLE probe: a sorted DOUBLE column of 5 distinct values
   (min(max(rows, 65536), 4194304) rows) and `SELECT sum(r), count(r)
   ... WHERE r < 9.0` against numpy; `agg_rle_runs` must move and
   `compressed_fallback_not_ported` stay 0;
10. the join path: generate orders (--sf x 1.5M rows, seed + 1) and load
   it; with `join_expand_max_bytes` and `join_build_cache_bytes` at 8 GiB
   and `pallas_group_reduce` on, launch counters and join counters set to
   0, TPC-H Q3C through `session.sql` once and --reps times warm, the
   counters read back: no host fallback, at least one device join, ONE
   build sort over all runs, and the grouped kernel launched on the
   joined rows.  Q3C against a float64 numpy oracle (per-order priority
   and date lookup, then `np.bincount` over lineitem: counts exact,
   revenue within rel 5e-5); the grouped kernel against its plain
   version on the inputs Q3C handed it (phase 5's tolerance), timed
   beside its bound; the build sort timed alone; the peak device memory;
   then the generic-key join (`GROUP BY o_orderdate`, about 2,400 groups)
   against numpy with `host_fallbacks` unchanged;
11. the tiled lane: `scan_tile_bytes` at a tenth of Q1's decoded bind of
   lineitem (the reference bench keeps its budget under 10% of the
   table), the table's device cache dropped, launch and tile counters set
   to 0, Q1 and Q6 through `session.sql` once and --reps times warm, the
   counters read back: `scan_tiles` = tiles x runs, device merges moved
   and host merges did not, `grouped_reduce` launched once per Q1 tile and
   `masked_kahan_sum` once per Q6 tile, look-ahead windows warmed with no
   prefetch worker death and no host fallback.  The answers equal phase
   4's and the oracle (counts exact, sums rel 1e-6); the peak device
   memory above the resident set stays under (tier_prefetch_depth + 2) x
   scan_tile_bytes + 64 MiB; each kernel against its plain version on the
   last tile's inputs, and the Kahan kernel on the first (full) tile's
   too (phase 5's checks and timings); seconds, rows/s, bytes uploaded
   per pass and the pinned host-to-device rate;
12. exact decimals: lineitem_dec (the first twelfth of the --sf x 6M
   generated rows, `DEC_DEPTH`, cut to keep the run inside its limit, with
   l_quantity, l_extendedprice, l_discount and l_tax as DECIMAL(15,2))
   loaded, Q1 and Q6 through `session.sql`: the exact slots are
   `Decimal`s equal, digit for digit, to an int64-cents numpy oracle, the
   float slots within rel 1e-6, no host fallback; Q1 tiled at phase 11's
   budget once and --reps times warm, merged on the device only, with its
   exact slots equal to the untiled run's at the column scale (with
   --profile, one more tiled run traced); a 5-row DECIMAL(18,0) probe whose max|v| x count passes 2^62
   reroutes to the host path (counted) and answers exactly;
13. `count(DISTINCT l_suppkey)` per (returnflag, linestatus) over lineitem
   against `np.unique` of the (group, key) pairs, with no host fallback;
   the `matmul` and `scatter` strategies on one Q1 tile's float sums
   (integer-valued, so the answers must be identical), timed;
14. subqueries and functions, each query with the launch counters set to
   0 just before it and read just after, once and --reps times warm, with
   its peak device memory: TPC-H Q4 (EXISTS as a semi join against the
   late lineitems, a five-group count through the grouped kernel) and Q22
   (customer loaded at a tenth of orders' rows; the scalar avg through
   the Kahan kernel, NOT EXISTS as an anti join) over the --sf tables;
   `FUNCTIONS_QUERY` (year, substr and abs in a GROUP BY) over lineitem;
   Q18 on a session of its own at SF 1, cut because its IN subquery's
   result substitutes one literal per passing order (about 4.6M at SF
   16), with max_groups at 2^21 (the subquery groups every order), the
   list's length and the subquery's and the outer query's seconds apart.
   Each answer against numpy (counts exact, sums rel 1e-6), no host
   fallback, one device join a run (two for Q18); over the phase both
   kernels must have launched.  The grouped kernel against its plain
   version on the inputs a warm Q4 run handed it, and the Kahan kernel on
   those of a warm Q22 run (phase 5's checks and timings);
15. window functions: `WINDOW_QUERY` (row_number, rank, dense_rank,
   running sum / count / avg / min / max and lag / lead of o_totalprice
   over o_custkey partitions, ORDER BY o_orderdate and o_totalprice DESC)
   over the orders of two years (about 7.4M of --sf x 1.5M rows), once
   and --reps times warm: its columns against a numpy oracle built from
   `np.lexsort` over the generated arrays (ranks, counts and NULLs exact,
   running values rel 1e-6 of the float32-rounded prices), no host
   fallback; first and warm seconds, peak device memory;
16. mutations on lineitem at --sf: (a) a thread pins lineitem
   (`mvcc.pinned_scope`) and reads Q1 / Q6; (b) `MUTATION_UPDATE` (about
   12% of rows; moves Q6), (c) `MUTATION_DELETE` (about 4%), (d) one
   insert of 131,072 rows, with seconds and rows/s; (e) Q1 and Q6 once
   and --reps times warm, launch counters at 0: both kernels launch,
   `compressed_fallback_deltas` moves, no host fallback, answers equal a
   float64 numpy oracle over the mutated arrays (counts exact, sums rel
   1e-6), each kernel against its plain version on a warm run's inputs;
   (f) the pinned reader's Q1 / Q6 again equal phase 4's, peak memory
   with both versions bound; (g) HTAP: scans of count(*) and
   sum(l_extendedprice) while a second session inserts 8 batches of
   131,072 rows, every scan equal to one of the 9 prefix states, scan
   p50 / p99 concurrent and serialized, ingest rows/s; (h) nation and
   region as row tables (`NATION_DDL`, `REGION_DDL`), TPC-H Q10 over
   customer, orders, lineitem and nation against numpy with device joins
   and no host fallback, PUT INTO nation (one upsert, one insert) read
   back through `session.get`, and PUT INTO a keyed column table;
17. the Kahan kernel under torch.profiler on phase 5's inputs and on
   phase 11's last tile (the first, full tile is timed in phase 11 only:
   a third child process cost about 25 s of the run), in one child
   process of this script per shape
   (`--kahan-profile`) that loads them from a file, so that its profiler
   starts fresh, and with spin kernels at the session's start (the
   profiler drops the device records of a session's first millisecond,
   PERF.md §7): one profiler session per shape, in which every device
   kernel but the spins is the Kahan kernel, the device's kernel records
   and the host's CUDA runtime records each hold exactly one kernel
   launch per call, and there is no copy, memset or torch op but the
   output's allocation; its mean device time (`device_ms`).  It runs
   after phase 26, and phase 28's routed ingest runs on a thread of this
   process beside it (its main thread waits on the child);
18. nested orders: `gen_orders(1,000,000)` with `gen_lineitem(4,000,000,
   seed 7)` nested by l_orderkey (`tpch.gen_orders_nested`: an `info`
   STRUCT, `modes` ARRAY<STRING>, `prices` ARRAY<DOUBLE>, `qty_by_mode`
   MAP<STRING, DOUBLE>; SF 2/3, `reduced`: the cells are Python objects
   on the host), ingested through `insert_arrays`; `NESTED_N1` (GROUP BY
   the two BOOLEAN keys array_contains(modes, 'AIR') and size(modes) >=
   4: the reference has no device dictionary for a GROUP BY over a
   struct's STRING field) and `NESTED_N2` once and --reps times
   warm, launch counters at 0: no host fallback, the grouped kernel
   launched by N1 and the Kahan kernel by N2, each against its plain
   version on a warm run's inputs, answers against a numpy oracle
   (counts exact, sums rel 1e-6); ingest rows/s, first and warm seconds,
   the complex plates' bytes on the card;
19. a durable lineitem: the first 1 / DURABLE_DEPTH (6,000,000 of SF 16's
   96M) of the rows in a session
   with `data_dir` under a temporary directory (its filesystem's free
   bytes first, removed at the end): (a) CREATE and `insert_arrays` in
   1,048,576-row statements (rows/s, WAL bytes, fsyncs); (b)
   `checkpoint()` (seconds, bytes on disk, the codec used); (c) phase
   16's UPDATE, DELETE and 131,072-row insert, journaled; (d) 4 threads x
   500 single-row INSERT statements in `group` mode (acks/s, fsyncs,
   group commits); (e) a second session on the open directory (the crash
   shape; recovery seconds), Q1 and Q6 once and --reps times warm
   through both kernels against numpy over the mutated rows, with
   `compressed_fallback_deltas` moving; (f) `run_compaction_pass` on the
   recovered table, then Q1 / Q6 again with no delta fallback and the
   grouped kernel's slot count; (g) a third session on the directory
   answers the same;
20. the resource governor, the tier ladder and self-healing on (g)'s
   session, its `want` oracle, before the stores close (the first two
   sessions are closed first, so the broker ledgers one lineitem):
   (a) the broker's ledger (host and device bytes per table) beside
   `memory_allocated` / `memory_reserved` and the process RSS; (b)
   `tier_device_bytes` at a quarter of the bound plates, a tiled Q1 at
   phase 11's budget (a tenth of Q1's decoded bind), `tier.maybe_demote`
   once the statement's pin is gone: entries dropped, ledger and
   allocator bytes before and after; (c) `tier_host_bytes` at a quarter
   of the table's host bytes, `maybe_demote` frames about three quarters
   of the batches into CRC-framed tier files (seconds, bytes, GB/s), then
   Q1 / Q6 once and --reps times warm over the memmapped batches (both
   kernels, answers against numpy) and a tiled Q1 over the disk tier;
   (d) `promote_table` (seconds), then one record corrupted through the
   `tier.write` `corrupt_bytes` failpoint, the retained epochs trimmed,
   and `promote_table` again: one file quarantined and one batch rebuilt
   through `DiskStore.load_batch`, Q1 / Q6 against numpy; (e) a
   `memory_limit_bytes` of half Q1's estimate rejects it (XCL54) with no
   kernel launch; a limit 5% above the measured residency walks the
   degradation ladder (`governor_degrade_*`) under a tiled Q1; a limit of
   1.25 tiles admits the tiled Q1; (f) a tiled Q1 at a quarter of that
   budget on a thread, cancelled after its first tile, then stopped by a
   50 ms `query_timeout_s`: XCL52 before the last tile, the ms from the
   cancel to the raise, no tile flag / pin / window / registration left,
   `memory_allocated` back at its level, then Q1 / Q6 against numpy; (g)
   the seeded fault storm (`reliability/faultstorm.run_storm`, 26 rounds)
   over a small durable table on the card: every injection accounted,
   no value mismatch; (h) `COMPACTION_UPDATE` writes l_discount back
   unchanged (deltas, the oracle untouched), the next admission kicks one
   background compaction sweep in the device scope, then Q1 / Q6 with no
   delta fallback and the grouped kernel back at phase 4's slot count
   (8 at SF 16).  The broker-kicked compactor stays off
   (`compaction_enabled`) from phase 3 until (h), so the earlier phases
   run as before;
21. right after phase 16, on the main session as phase 16 leaves
   lineitem: views, materialized views and SQL functions.  (a) TPC-H Q15:
   supplier at --sf (160,000 rows at SF 16), `Q15_VIEW`, then `Q15` (first
   and warm seconds, peak memory, the reference's routing: two host
   fallbacks a run, no device join; the top supplier against numpy);
   (b) `rev(p, d) = p * d` in Q6 (the Kahan kernel once a run, no host
   fallback, Q6's oracle) and `capped(x) = jnp.clip(x, 10, 40)` in Q1's
   GROUP BY (the grouped kernel), seconds beside phase 4's; (c)
   `q1_mv`, a materialized Q1 (keys, three sums, count): the create's
   seconds (one full refresh), the warm read's, the broker's
   `matview_state_bytes` beside `state_nbytes()`, `memory_allocated`
   and the ledger's device bytes per table before and after; (d) inserts
   of 1 and 1,024 rows (the 131,072-row insert was cut to keep the run's
   time), each insert's seconds and its fold's share, the view against
   numpy after each; (e) a DELETE of the rows of orders 1 ..
   `VIEW_DELETE_KEYS` subtracts (the view stays fresh and exact; a few
   dozen rows, so its capture decodes a few batches, not every batch as
   the 1,074,563-row DELETE of l_shipdate > 1998-11-01 did), an
   UPDATE of l_discount marks it stale and the next read refreshes in
   full, and DROP MATERIALIZED VIEW leaves no device bytes under the
   view, its backing table or its scratch tables; the grouped kernel on (c)'s refresh inputs and the Kahan kernel
   on (b)'s Q6 inputs against their plain versions; (f) a durable
   session of its own over the first 1,000,000 generated rows (cut from
   2,000,000 to keep the run's time): q1_mv,
   rev() and a plain view, a checkpoint, two inserts as the WAL tail, a
   crash-shape reopen: the state reloads, the tail alone folds, and the
   view, rev()'s Q6 and the plain view equal numpy (checkpoint and
   recovery seconds);
22. right after phase 21, on the main session as phase 21 leaves
   lineitem (not cut): (a) SQL `PREPARE q6p AS` Q6 with `?` for the two
   ship-date bounds, the discount band and the quantity, `EXECUTE` with
   three bind vectors once and --reps times warm: each answer equal to
   the literal `session.sql` query and to numpy, no plan-cache miss of an
   EXECUTE, the registry's hits, one Kahan launch per execute; (b) the
   micro-batcher at `serving_batch_max` 16 and `serving_batch_wait_us`
   200: 1, 4 and 16 client threads x 8 `handle.execute` calls with
   distinct binds (years 1993 - 1997 x four discount bands), requests/s,
   per-request p50 / p99, fused dispatches and their occupancy, the
   Kahan kernel launched once per request, no batch fallback, every
   answer equal to its solo answer; then the same with a Q1 whose ship
   date is a `?` (the grouped kernel); (c) the group-index cache: the
   prepared Q1 three times with one bind (1 miss, 2 hits, miss and hit
   seconds, the ledger's `gidx_cache_bytes` equal to the cache's bytes,
   `memory_allocated` before and after), a 1-row insert, then a miss;
   (d) a row table of 150,000 SF 1 customer rows (`reduced`: row-table
   inserts are host rows) with `CREATE INDEX` on c_name, 500 lookups
   through `session.sql` and 500 through a prepared handle's point
   lane: lookups/s, `point_lookups`, no kernel launch; (e) `CREATE
   POLICY` on lineitem (l_tax < 0.05) under the held Q6 handle: one
   re-prepare, the answer equal to numpy over the filtered rows, then
   `DROP POLICY`.  With --profile: one fused 16-request Q6 dispatch and
   one group-index cache hit of the prepared Q1;
23. AQP (`reduced`): a lineitem of 2,097,152 rows (seed 7) on a session
   of its own, `CREATE SAMPLE TABLE` with qcs (l_returnflag,
   l_linestatus) and 10,000 rows a stratum (build seconds), a Q1-shaped
   GROUP BY `WITH ERROR 0.1 CONFIDENCE 0.95` (the grouped kernel; each
   group's estimate, bounds and whether the exact value lies inside), a
   global avg `WITH ERROR` (its moments group by stratum: the grouped
   kernel) and the same avg through `approx_sql` (weighted global sums:
   the Kahan kernel), then a TopK over l_suppkey (build seconds; no
   reported count below the true count);
24. right after phase 22, on the main session as phase 22 leaves it
   (no new data): (a) plain `EXPLAIN` of Q1 and Q6 launches nothing;
   `EXPLAIN ANALYZE` of each gives the plain query's row count, names
   `grouped` (Q1) / `kahan` (Q6) in its strategies, launches that kernel
   exactly once, puts its trace id in `tracing.ring()`, and its phase
   seconds sum to at most the call's wall time; (b) warm Q1, Q6 and
   phase 22's 500 prepared index lookups with `tracing_enabled` on and
   off, 5 x --reps interleaved pairs, medians and quartiles: the
   overhead in percent beside the reference's 3% bound (logged, not
   checked); (c)
   `for_user("analyst")` keeps the session's device, its Q6 raises
   PermissionError before admission (no launch, the ledger unchanged),
   after `GRANT SELECT ON lineitem` equals the admin's Q6 bit for bit
   with one Kahan launch, a prepared Q6 under analyst equals the
   admin's, and after `REVOKE` the held handle's next execute raises;
   (d) `TableStatsService.collect_once()` and the encoding mix: each
   table's device bytes equal `device_cache_bytes_by_table` and the
   broker's ledger; `to_prometheus()` parses with unique family names;
   `recent_queries()` holds the phase's queries with user and ms.  Phase
   20 (f)'s cancelled tiled Q1 also carries its trace id, an error
   trace in the ring;
25. right after phase 24, on the main session as phase 24 leaves it (no
   new data but (d)'s): one `SnappyFlightServer` and one `RestService`
   over it on 127.0.0.1, port 0.  (a) Q1 and Q6 through
   `SnappyClient.sql`, once and --reps times warm: the Arrow rows equal
   `session.sql`'s bit for bit, one grouped (Q1) or Kahan (Q6) launch a
   request, the wall beside the in-process warm time; (b) Flight SQL: the
   statement Q6, GetTables lists lineitem, a prepared Q6 with five binds
   (each equal to the in-process prepared answer, one Kahan launch each,
   the second execute a `serving_prepared_hits` hit); (c) the streamed
   scan `STREAM_SCAN` (LIMIT 1000): `stream_scan_early_stops` 1, its
   chunks and the batches it decoded of the table's, rows equal
   `session.sql`'s; (d) `do_put` of `PUT_ROWS` (1,048,576) generated
   lineitem rows into `lineitem_put` (rows/s), then Q6 over it through
   Flight against numpy with one Kahan launch; (e) REST: `POST /sql` Q6
   twice (through `serving_sql`: a registry hit, a trace id, one launch
   each), a `/jobs` Q1 polled to its end (one grouped launch),
   `/status/api/v1/storage` device bytes beside the stats service's
   (`/status/api/v1/scan`) and the broker's ledger, `/metrics/prometheus`
   parsed, `/status/api/v1/traces?trace_id=` holding (a)'s Flight Q1 as a
   client and a server trace under the id the client sent; (f) Q6 at 1,
   4 and 16 client threads, `FRONT_DOOR_REQUESTS` (256) requests a level
   on the same binds, first in process through the prepared handle, then
   through Flight (prepared, the server's micro-batcher): requests/s and
   p50 / p99 of each, every answer equal to its solo answer, one Kahan
   launch a request;
26. right after phase 23, on a session of its own: (a) a `memory_stream`
   table with lineitem's columns takes the first `STREAM_ROWS`
   (4,194,304; `reduced` from SF 16: each micro-batch appends and
   re-binds on the host) generated rows in micro-batches of
   `STREAM_BATCH` (131,072) on the stream's own thread: rows/s and the
   p50 / p99 of a micro-batch's apply; Q1 and Q6 once and --reps times warm
   through the grouped and Kahan kernels (one launch a run) against numpy
   over the delivered rows, and Q6 over a `WINDOW (DURATION ...
   MILLISECONDS)` whose cutoff falls midway between two micro-batches'
   arrival stamps against numpy over the later half of the stream, a
   warm windowed Q6 with no plan-cache miss; (b) a keyed
   `kafka_stream` over a `FileBroker` in a temporary directory, stopped
   after its first batches and restarted from its offset log while the
   rest is published: every one of `KAFKA_RECORDS` ids exactly once;
   (c) `q1_mv` over a keyless memory stream folds once per micro-batch
   (`MV_BATCHES`, no full refresh) and equals its defining query;
27. right after phase 25, on the main session (no new data): a
   `LocatorNode`, a `ServerNode` and a primary `LeadNode` (`lease_s` 0.5,
   `MEMBER_LEASE_S`) in this process, each over a session of its own on
   the main catalog.  (a) Q1 and Q6 through `SnappyClient(locator=)`,
   once and --reps times warm: rows equal `session.sql`'s bit for bit,
   one grouped (Q1) or Kahan (Q6) launch a request, the warm wall beside
   phase 25's direct-address Flight time; (b) the member the client
   talks to stops: the next Q6, its reconnect included, equal, and the
   member it failed over to; (c) a second server and a standby lead
   join, the primary stops: seconds until the standby is primary and its
   `/status/api/v1/cluster` lists the live members, against `lease_s`
   and `member_timeout_s`, then Q1 through the new primary's Flight
   address (equal, one launch); (d) `python -m snappydata_tpu_torch
   server --locator ...` (no --device: cuda) in a process of its own,
   against a locator of its own, started before phase 25 so that its
   interpreter and CUDA context come up while phase 25 runs, and
   stopped after phase 27 whatever happened: its start seconds, a table
   made by `sql --locator ... -e` (a CTAS), read by another `sql -e`
   beside `status`, which lists that one server; every process stopped;
28. right after phase 17: the distributed session.  Two `python -m
   snappydata_tpu_torch server --locator ...` processes (no --device:
   cuda), started before phase 25 beside phase 27's, and a
   `DistributedSession(locator=...)` on the card in this process, made
   at the top of phase 17: `SET pallas_reduce` / `pallas_group_reduce`
   on each server over Flight, `tpch.LINEITEM_DDL` (partitioned on
   l_orderkey) fanned out, and beside phase 17 on a thread the routed
   ingest of the first 1 / `DIST_DEPTH` of lineitem (12,000,000 rows of
   SF 16: Flight and the servers' host encoding set the rate, and at this
   depth the ingest ends before phase 17 does) and its numpy oracle.  Then: (a) each server's row count, summing to the
   total; (b) Q1 and Q6 once and --reps times warm against numpy
   (counts exact, sums rel 1e-6), the lead's merge seconds apart from
   the fan-out, and each server's launches of the grouped (Q1) or Kahan
   (Q6) kernel over those timed runs, at least one a run: the `kernels`
   line of `EXPLAIN ANALYZE` over Flight, counted in the server's
   process, gives the wrapper's count before (`DIST_PROBE`) and after
   them (the partial fragment, its own pass left out), the server's
   device (cuda) and its lineitem plate bytes resident there (> 0);
   (c) `DIST_SCAN`, concatenated, its row count exact; (d) `DIST_UPDATE`
   fanned out (its count exact), then Q6 again against numpy, its Kahan
   launches counted the same way; (e) each server's rows and batch
   bytes from its Flight `stats` action; no `dist_downgrades`.  Both
   server processes are stopped whatever happened;
29. right after phase 10, on the main session as phase 10 leaves
   lineitem and orders: multi-slot execution.  `mesh_slots` at
   `MESH_SLOTS` (4), the session's `default_mesh = data_mesh(4)`: every
   slot on cuda:0 (printed with the card's name), the slots' blocks views
   of the plates phases 4 and 10 bound (nothing re-uploads).  Q1 and Q6
   once and --reps times warm against phase 4's numpy oracle (counts
   exact, sums rel 1e-6), each run one per-slot lane run
   (`mesh_shard_execs`) launching the grouped (Q1) or Kahan (Q6) kernel at
   least once a slot, their warm seconds beside phase 4's (the slots share
   one card's SMs: the lane's overhead, not scaling); Q3C with
   `mesh_join_strategy` at `broadcast`, then at `shuffle`, once and --reps
   times warm, each against phase 10's rows (rel 1e-6), the grouped kernel
   at least once a slot, the strategy's counter once a run, and the
   shuffle exchange's seconds, bytes, moved rows and cache hits; per-slot
   resident bytes (`device_cache_bytes_by_device`) beside the
   single-device bind's; `resize_mesh(2)`: its seconds, moved buckets and
   entries, the host-to-device bytes during it and the per-slot bytes
   after; Q1 again against the oracle.  Any `mesh_fallback_*`, host
   fallback or slot off cuda:0 fails the phase; the mesh and its cache
   entries go at its end;
30. right after phase 29, on the main session: the TPC-DS kit
   (`utils/tpcds.load_tpcds` at --tpcds-sf, 10 by default: store_sales
   28,800,000 rows, item 180,000, customer 1,000,000, customer_address
   500,000, store 120, date_dim 1,825; `reduced` from the kit's larger
   scale factors by the run's time limit), each table's load seconds;
   its eight queries (q3, q42, q52, q55, q19, q6, q36, q98) through
   `session.sql` once and --reps times warm with both kernel knobs on,
   launch counters at 0 before each: every answer against a float64
   numpy / pandas oracle over the generated arrays (keys and counts
   exact, same-sign sums rel 1e-6, q36's margin within the bound its two
   sums give, q98's ratio rel 2e-6; ties at the ORDER BY and the LIMIT
   within those tolerances), each query's lane with the engine's reason
   when it leaves the device (only q6, q19 and q98, which the reference's
   CPU branch declines too, may), its launches a run and join counters,
   no host join; the grouped kernel launched on every run of q6 and q36
   (the queries whose GROUP BY keys are dictionary keys with at most 64
   groups: the kernel's gate in both packages; the others group by INT
   keys on the generic key lane) and held against its plain version on
   the first inputs the phase handed it, the Kahan kernel likewise (q36's
   grand total); the native encoder loaded with no plain-encoder call in
   the whole run (`native_fallbacks` 0); the kit's tables dropped at the
   end.  With --tpcds-only the script runs phases 1, 2 and 30 alone on a
   session of its own and prints no result line;
31. the kernels' JSON line, then `{"ok": true, "device": ...}` last.  Each
   kernel's `launches` counts its main-path runs of phases 4, 11, 14, 16,
   18 - 27, 29 and 30 in this process (phase 28's run in the servers'
   processes).  `phase_s <n> <s>` gives each phase's seconds and
   `phase_total_s` their sum.

The bound of a kernel is the larger of its bytes (each input read once,
each output written once) over 3.35 TB/s and its float32 operations over
67 TFLOP/s (H100 SXM data sheet).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
ROWS_PER_SF = 6_000_000
ORDERS_PER_SF = 1_500_000
KERNELS = ("kahan_reduce", "group_reduce", "code_filter_sum",
           "group_code_reduce")
RLE_PROBE_ROWS = (1 << 16, 1 << 22)
DEC_DEPTH = 12       # lineitem_dec holds 1 / DEC_DEPTH of lineitem's rows
DURABLE_DEPTH = 16   # phases 19 - 20 take 1 / DURABLE_DEPTH of lineitem's rows


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of `fn` over `reps` calls after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Recorder:
    """Wraps a kernel wrapper to keep the arguments of its first `keep`
    calls (all of them when `keep` is None), or with `ends` only of its
    first and its most recent call."""

    def __init__(self, fn, keep=None, ends=False):
        self.fn = fn
        self.keep = keep
        self.ends = ends
        self.calls = []

    def __call__(self, *args):
        if self.ends:
            self.calls = self.calls[:1] + [args]
        elif self.keep is None or len(self.calls) < self.keep:
            self.calls.append(args)
        return self.fn(*args)


def run_queries(session, tpch):
    """Q1 and Q6 through the user entry point; (rows, seconds) each."""
    import torch

    out = {}
    for name, q in (("q1", tpch.Q1), ("q6", tpch.Q6)):
        t0 = time.perf_counter()
        rows = session.sql(q).rows()
        torch.cuda.synchronize()
        out[name] = (rows, time.perf_counter() - t0)
    return out


def flag_status_code(flag, status):
    """Q1's group as one small code a row: 2 * flag (A 0, N 1, R 2) +
    status (F 0, O 1), from the two object columns."""
    import numpy as np

    return ((flag == "N").astype(np.int8) + 2 * (flag == "R")) * 2 \
        + (status == "O")


def oracle(li, tpch, code=None):
    """Q1 / Q6 in float64 numpy straight from the generated arrays (or
    their `view_arrays` form); `code`, when given, is the rows'
    `flag_status_code`, so the string compares run once."""
    import numpy as np

    if code is None:
        code = li["g"] if "g" in li else \
            flag_status_code(li["l_returnflag"], li["l_linestatus"])
    qty, price = li["l_quantity"], li["l_extendedprice"]
    disc, tax, ship = li["l_discount"], li["l_tax"], li["l_shipdate"]
    # rows past Q1's cutoff count in a seventh bin that is dropped: the
    # same sums in the same order as masking every weight column
    g = np.where(ship <= tpch._days("1998-12-01") - 90, code, 6)

    def per(w):
        return np.bincount(g, weights=w, minlength=7)[:6]

    cnt = np.bincount(g, minlength=7)[:6]
    net = price * (1 - disc)
    sums = [per(qty), per(price), per(net), per(net * (1 + tax))]
    avgs = [sums[0], sums[1], per(disc)]
    q1 = []
    for code in range(6):
        if cnt[code] == 0:
            continue
        key = ("ANR"[code // 2], "FO"[code % 2])
        q1.append(key + tuple(s[code] for s in sums)
                  + tuple(a[code] / cnt[code] for a in avgs)
                  + (int(cnt[code]),))
    q1.sort(key=lambda r: r[:2])
    m6 = (ship >= tpch._days("1994-01-01")) \
        & (ship < tpch._days("1995-01-01")) \
        & (disc >= 0.05) & (disc <= 0.07) & (qty < 24)
    q6 = [(float((price[m6] * disc[m6]).sum()),)]
    return {"q1": q1, "q6": q6}


def check_rows(what, got, want, rel=1e-6):
    import math

    if len(got) != len(want):
        fail(f"{what}: {len(got)} rows, expected {len(want)}")
    for g, w in zip(got, want):
        if len(g) != len(w):
            fail(f"{what}: row width {len(g)}, expected {len(w)}")
        for a, b in zip(g, w):
            if isinstance(b, str) or isinstance(b, int):
                if a != b:
                    fail(f"{what}: {g} != {w}")
            elif not (math.isfinite(a) and abs(a - b) <= rel * abs(b)):
                fail(f"{what}: {a!r} vs {b!r} (rel {rel})")


def launch_records(prof):
    """(host CUDA runtime kernel-launch records, device kernel records)
    of a finished torch.profiler session: equal when the trace kept
    every kernel the calls launched."""
    import torch

    runtime = device = 0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not e.key.startswith(("Memcpy", "Memset")):
                device += e.count
        elif "LaunchKernel" in e.key or "LaunchCooperativeKernel" in e.key:
            runtime += e.count
    return runtime, device


TRACE_DIR = []   # set by --trace-dir
SPIN = "spin_kernel"   # torch.cuda._sleep's kernel


def spin_prelude(spin_s, pad_s):
    """Open a torch.profiler session with `spin_s` seconds of
    `torch.cuda._sleep` spin kernels, which take the profiler's loss of
    the kernel records of about the first millisecond after a session's
    first launch (PERF.md §7), then `pad_s` seconds of host sleep.
    Returns the number of spin kernels launched; the caller leaves them
    out of every figure."""
    import torch

    spins = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < spin_s:
        torch.cuda._sleep(20_000)
        spins += 1
    torch.cuda.synchronize()
    time.sleep(pad_s)
    return spins


def profile_run(fn, top=8, pad_s=1.0, spin_s=0.02):
    """One warm call of `fn` under torch.profiler: wall ms, the summed
    device time of its kernels, the device's idle share of the wall time,
    the kernels with the most device time, and the runtime launch and
    device kernel record counts of the call (`whole` when they agree).

    Each session opens with `spin_prelude(spin_s, pad_s)`, whose spin
    kernels are left out of every figure.  With
    --trace-dir, a trace whose call lost records is also written there as
    a Chrome trace (`trace` names the file)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        spins = spin_prelude(spin_s, pad_s)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(pad_s)
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and SPIN not in e.key]
    dev_ms = sum(e.self_device_time_total for e in dev) / 1e3
    dev.sort(key=lambda e: -e.self_device_time_total)
    runtime, kept = launch_records(prof)
    runtime -= spins
    kept -= sum(e.count for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and SPIN in e.key)
    trace = None
    if TRACE_DIR and runtime != kept:
        os.makedirs(TRACE_DIR[0], exist_ok=True)
        trace = os.path.join(TRACE_DIR[0],
                             f"profile_{len(os.listdir(TRACE_DIR[0]))}.json")
        prof.export_chrome_trace(trace)
    return {"wall_ms": wall_ms, "device_ms": dev_ms, "trace": trace,
            "idle_share": 1 - dev_ms / wall_ms if dev_ms else None,
            "runtime_launches": runtime, "trace_kernels": kept,
            "whole": runtime == kept, "spins": spins,
            "top": [(e.key[:60], e.count, e.self_device_time_total / 1e3)
                    for e in dev[:top]]}


def kahan_phase(calls, reps):
    """The Kahan kernel on the first recorded call's inputs: against its
    plain version (1e-6 * sum(|v|)), bit-identical over two calls, `ms`
    over back-to-back calls between two events (host dispatch counts),
    its launch configuration."""
    import torch

    from snappydata_tpu_torch.ops.kahan_reduce import (
        masked_kahan_sum, masked_kahan_sum_plain)

    if not calls:
        fail("masked_kahan_sum saw no call on the main path")
    v, w = calls[0]
    n = v.numel()
    got = masked_kahan_sum(v, w)
    again = masked_kahan_sum(v, w)
    plain = masked_kahan_sum_plain(v, w)
    torch.cuda.synchronize()
    err = abs(float(got) - float(plain))
    scale = float(torch.where(w, v.double().abs(), 0).sum())
    if not err <= 1e-6 * scale:
        fail(f"masked_kahan_sum: |kernel - plain| = {err} > 1e-6 * {scale}")
    if float(got) != float(again):
        fail(f"masked_kahan_sum: two calls differ ({float(got)!r}, "
             f"{float(again)!r})")
    b_ms, b_by = bound(n * 4 + n * 1 + 8, 4 * n)
    return {
        "max_abs_err": err,
        "ms": cuda_ms(lambda: masked_kahan_sum(v, w), reps * 10),
        "plain_ms": cuda_ms(lambda: masked_kahan_sum_plain(v, w), reps),
        "library_ms": cuda_ms(
            lambda: torch.where(w, v, 0).double().sum(), reps * 10),
        "bound_ms": b_ms, "bound_by": b_by, "rows": n,
        "config": masked_kahan_sum.config}


def kahan_profile(v, w, reps):
    """The Kahan kernel's calls on (v, w) in one torch.profiler session,
    after one warm-up call.  The host's CUDA runtime records and the
    device's kernel records must each hold one kernel launch per call,
    every device kernel in the trace must be the Kahan kernel, there must
    be no copy or memset, the only torch op must be the output's
    allocation (`aten::empty`), and the wrapper's launch count must move
    by the calls.  Run in a fresh process, one for each shape
    (`kahan_profile_child`), and opened with `spin_prelude`, whose spin
    kernels are left out: the profiler drops the kernel records of about
    the first millisecond of a session (PERF.md §7), which here is the
    start of the calls themselves.  `device_ms` is the kernel records'
    mean device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from snappydata_tpu_torch.ops.kahan_reduce import masked_kahan_sum

    calls = reps * 10
    masked_kahan_sum(v, w)
    torch.cuda.synchronize()
    before = masked_kahan_sum.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        spins = spin_prelude(0.02, 1.0)
        for _ in range(calls):
            masked_kahan_sum(v, w)
        torch.cuda.synchronize()
        time.sleep(1.0)
    launched = masked_kahan_sum.launches - before
    host, dev = {}, {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if SPIN not in e.key:
                dev[e.key] = (e.count,
                              e.self_device_time_total / e.count / 1e3)
        else:
            host[e.key] = e.count
    runtime_launches, _kept = launch_records(prof)
    runtime_launches -= spins
    copies = {k: c for k, c in host.items()
              if "Memcpy" in k or "Memset" in k}
    torch_ops = {k: c for k, c in host.items()
                 if k.startswith("aten::") and k != "aten::empty"}
    kahan = [(c, ms) for k, (c, ms) in dev.items()
             if "kahan_sum_kernel" in k]
    if launched != calls or runtime_launches != calls or copies \
            or torch_ops or len(dev) != 1 or not kahan \
            or kahan[0][0] != calls:
        fail(f"masked_kahan_sum: {launched} wrapper launches over {calls} "
             f"calls gave {runtime_launches} runtime kernel launches, "
             f"copies {copies}, torch ops {torch_ops}, device kernels "
             f"{dev}; expected one kernel per call and nothing else")
    return {"device_ms": kahan[0][1], "runtime_launches": runtime_launches,
            "trace_kernels": kahan[0][0], "calls": calls, "rows": v.numel()}


def kahan_profile_child(shapes, reps, root):
    """`kahan_profile` on each (label, (v, w)) of `shapes`, each in a
    child process of its own, which loads its inputs from a file under
    the gitignored build directory; returns (label, result) pairs and
    fails when a child does."""
    import torch

    path = os.path.join(root, "snappydata_tpu_torch", "build",
                        "kahan_profile_inputs.pt")
    results = []
    for label, (v, w) in shapes:
        torch.save([(label, v.cpu(), w.cpu())], path)
        try:
            child = subprocess.run(
                [sys.executable, os.path.abspath(__file__),
                 "--kahan-profile", path, "--reps", str(reps)],
                capture_output=True, text=True, timeout=600)
        finally:
            os.remove(path)
        if child.returncode != 0:
            fail(f"the Kahan profile child on the {label} exited "
                 f"{child.returncode}:\n"
                 f"{child.stdout[-4000:]}{child.stderr[-4000:]}")
        out = [json.loads(line) for line in child.stdout.splitlines()
               if line.startswith("{")]
        if [r["label"] for r in out] != [label]:
            fail(f"the Kahan profile child printed {child.stdout[-4000:]}")
        results.append((label, {k: x for k, x in out[0].items()
                                if k != "label"}))
    return results


def kahan_profile_main(path, reps):
    """The child's side of `kahan_profile_child`: one JSON line per
    shape."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    for label, v, w in torch.load(path):
        r = kahan_profile(v.cuda(), w.cuda(), reps)
        log(json.dumps({"label": label, **r}))
    return 0


def grouped_phase(calls, reps):
    import torch

    from snappydata_tpu_torch.ops.group_reduce import (
        grouped_reduce, grouped_reduce_plain)

    if not calls:
        fail("grouped_reduce saw no call on the main path")
    ops, gidx, G = calls[0]
    n = gidx.numel()
    got = grouped_reduce(ops, gidx, G)
    config = dict(grouped_reduce.config)
    plain = grouped_reduce_plain(ops, gidx, G)
    torch.cuda.synchronize()
    err = 0.0
    for (kind, v, w), k, p in zip(ops, got, plain):
        if kind in ("count", "min", "max"):
            same = (k == p) | (torch.isinf(k) & torch.isinf(p) & (k == p))
            if not bool(same.all()):
                fail(f"grouped_reduce {kind}: kernel {k.tolist()} != "
                     f"plain {p.tolist()}")
            continue
        diff = (k - p).abs()
        scale = torch.zeros(G, dtype=torch.float64, device=gidx.device)
        scale.index_add_(0, gidx.long(), torch.where(w, v.double().abs(), 0))
        if not bool((diff <= 1e-6 * scale + 1e-9).all()):
            fail(f"grouped_reduce sum: |kernel - plain| {diff.tolist()} "
                 f"beyond 1e-6 * sum(|v|) {scale.tolist()}")
        err = max(err, float(diff.max()))
    values = {id(v) for _k, v, _w in ops if v is not None}
    masks = {id(w) for _k, _v, w in ops}
    nbytes = n * 4 + 4 * n * len(values) + n * len(masks) + 8 * G * len(ops)
    nops = n * sum(4 if k == "sum" else 1 for k, _v, _w in ops)
    b_ms, b_by = bound(nbytes, nops)
    # the library yardstick: one index_add_ of the same sums and counts,
    # packed as [n, ops] float64 columns beforehand (packing not timed)
    idx = gidx.long()
    packed = torch.stack(
        [torch.where(w, v, 0).double() if v is not None else w.double()
         for _k, v, w in ops if _k in ("sum", "count")], dim=1)
    return {
        "max_abs_err": err,
        "ms": cuda_ms(lambda: grouped_reduce(ops, gidx, G), reps * 10),
        "plain_ms": cuda_ms(lambda: grouped_reduce_plain(ops, gidx, G),
                            reps),
        "library_ms": cuda_ms(
            lambda: torch.zeros(G, packed.shape[1], dtype=torch.float64,
                                device=idx.device).index_add_(0, idx, packed),
            reps * 10),
        "bound_ms": b_ms, "bound_by": b_by, "rows": n, "ops": len(ops),
        "groups": G, "config": config}


def code_filter_phase(calls, reps):
    import torch

    from snappydata_tpu_torch.ops.kahan_reduce import (
        code_filter_mask, decode_rows, fused_code_filter_sum,
        fused_code_filter_sum_plain)

    if not calls:
        fail("fused_code_filter_sum saw no call on the compressed path")
    args = calls[0]
    q, d, ship, price, valid, dicts, qhi, dlo, dhi, slo, shi = args
    got_s, got_n = fused_code_filter_sum(*args)
    plain_s, plain_n = fused_code_filter_sum_plain(*args)
    torch.cuda.synchronize()
    if int(got_n) != int(plain_n):
        fail(f"fused_code_filter_sum count: kernel {int(got_n)} != plain "
             f"{int(plain_n)}")
    ok = code_filter_mask(q, d, ship, valid, qhi, dlo, dhi, slo, shi)
    prod = price.double() * decode_rows(d, dicts).double()
    scale = float(torch.where(ok, prod.abs(), 0).sum())
    err = abs(float(got_s) - float(plain_s))
    if not err <= 1e-6 * scale:
        fail(f"fused_code_filter_sum: |kernel - plain| = {err} > 1e-6 * "
             f"{scale}")
    n = price.numel()
    B = price.shape[0]
    nbytes = n * (q.element_size() + d.element_size() + 4 + 4 + 1) \
        + dicts.numel() * 4 + 3 * B * 4 + 16
    b_ms, b_by = bound(nbytes, 5 * n)   # a product and four Kahan adds

    def library():
        keep = (valid & (q.int() < qhi[:, None]) & (d.int() >= dlo[:, None])
                & (d.int() <= dhi[:, None]) & (ship >= slo) & (ship < shi))
        dv = torch.gather(dicts, 1, d.long())
        return torch.where(keep, price * dv, 0).double().sum(), keep.sum()

    return {
        "max_abs_err": err,
        "ms": cuda_ms(lambda: fused_code_filter_sum(*args), reps * 10),
        "plain_ms": cuda_ms(lambda: fused_code_filter_sum_plain(*args),
                            reps),
        "library_ms": cuda_ms(library, reps * 10),
        "bound_ms": b_ms, "bound_by": b_by, "rows": n, "batches": B,
        "count": int(got_n)}


def code_grouped_phase(calls, reps):
    import torch

    from snappydata_tpu_torch.ops.group_reduce import (
        grouped_code_reduce, grouped_code_reduce_plain, slot_values)

    if not calls:
        fail("grouped_code_reduce saw no call on the compressed path")
    gidx, mask, slots, G = calls[0]
    got = grouped_code_reduce(gidx, mask, slots, G)
    config = dict(grouped_code_reduce.config)
    plain = grouped_code_reduce_plain(gidx, mask, slots, G)
    torch.cuda.synchronize()
    idx = gidx.reshape(-1).long()
    m = mask.reshape(-1)
    err = 0.0
    values = []
    for slot, k, p in zip(slots, got, plain):
        if slot[0] == "count":
            if not bool((k == p).all()):
                fail(f"grouped_code_reduce count: kernel {k.tolist()} != "
                     f"plain {p.tolist()}")
            values.append(m.double())
            continue
        v = slot_values(slot, gidx.shape, gidx.device).reshape(-1)
        values.append(torch.where(m, v, 0).double())
        scale = torch.zeros(G, dtype=torch.float64, device=gidx.device)
        scale.index_add_(0, idx, values[-1].abs())
        diff = (k - p).abs()
        if not bool((diff <= 1e-6 * scale + 1e-9).all()):
            fail(f"grouped_code_reduce sum: |kernel - plain| "
                 f"{diff.tolist()} beyond 1e-6 * sum(|v|) {scale.tolist()}")
        err = max(err, float(diff.max()))
    n = gidx.numel()
    plains = {id(s[1]): s[1] for s in slots if s[0] == "sum"
              and s[1] is not None}
    codes = {id(c): c for s in slots if s[0] == "sum" for c, _ in s[2]}
    dicts = {id(dc): dc for s in slots if s[0] == "sum" for _, dc in s[2]}
    nbytes = n * (4 + 1 + 4 * len(plains)
                  + sum(c.element_size() for c in codes.values())) \
        + sum(dc.numel() * 4 for dc in dicts.values()) + 8 * G * len(slots)
    nops = n * sum(1 if s[0] == "count" else 4 + len(s[2])
                   + (s[1] is not None) for s in slots)
    b_ms, b_by = bound(nbytes, nops)
    # the library yardstick: one index_add_ of the slots' decoded products
    # and the count, packed as [n, slots] float64 beforehand (not timed)
    packed = torch.stack(values, dim=1)
    return {
        "max_abs_err": err,
        "ms": cuda_ms(lambda: grouped_code_reduce(gidx, mask, slots, G),
                      reps * 10),
        "plain_ms": cuda_ms(
            lambda: grouped_code_reduce_plain(gidx, mask, slots, G), reps),
        "library_ms": cuda_ms(
            lambda: torch.zeros(G, packed.shape[1], dtype=torch.float64,
                                device=idx.device).index_add_(0, idx, packed),
            reps * 10),
        "bound_ms": b_ms, "bound_by": b_by, "rows": n, "slots": len(slots),
        "groups": G, "config": config}


def code_domain_checks(session, tpch, first, want, q6_out, q1_out):
    """Phase 7's answers against the session's own and the oracle."""
    rel = 5e-5
    exp_cnt = session.sql(
        "SELECT count(*) FROM lineitem "
        "WHERE l_shipdate >= DATE '1994-01-01' "
        "AND l_shipdate < DATE '1995-01-01' "
        "AND l_discount BETWEEN 0.05 AND 0.07 "
        "AND l_quantity < 24").rows()[0][0]
    revenue, count = q6_out
    if count != exp_cnt:
        fail(f"code_domain_q6 count {count} != session {exp_cnt}")
    check_rows("code_domain_q6 vs session", [(revenue,)], first["q6"][0],
               rel)
    check_rows("code_domain_q6 vs numpy oracle", [(revenue,)], want["q6"],
               rel)
    live = [r for r in q1_out if r[2] > 0]
    for what, rows in (("session", first["q1"][0]),
                       ("numpy oracle", want["q1"])):
        check_rows(f"code_domain_q1 vs {what}",
                   [r[:2] + r[3:] + (r[2],) for r in live],
                   [r[:6] + (r[9],) for r in rows], rel)


def rle_probe(session, n_rows, reps):
    """Phase 9: the reference bench's run-space probe through
    `session.sql`; (rows, seconds of the first and the best warm run)."""
    import numpy as np

    from snappydata_tpu_torch.observability.metrics import global_registry

    n = int(min(max(n_rows, RLE_PROBE_ROWS[0]), RLE_PROBE_ROWS[1]))
    rng = np.random.default_rng(7)
    rvals = np.sort(rng.choice(np.array([1.0, 2.0, 5.0, 9.0, 12.0]), n))
    session.sql("CREATE TABLE code_agg_rle (r DOUBLE) USING column")
    session.insert_arrays("code_agg_rle", [rvals])
    session.catalog.describe("code_agg_rle").data.force_rollover()
    q = "SELECT sum(r), count(r) FROM code_agg_rle WHERE r < 9.0"
    reg = global_registry()
    before = reg.counter("agg_rle_runs")
    times = []
    for _ in range(1 + reps):
        t0 = time.perf_counter()
        rows = session.sql(q).rows()
        times.append(time.perf_counter() - t0)
    if reg.counter("agg_rle_runs") - before != 1 + reps:
        fail("the RLE probe did not take the run-space lane "
             f"(agg_rle_runs moved {reg.counter('agg_rle_runs') - before})")
    if reg.counter("compressed_fallback_not_ported"):
        fail("a column was rerouted as compressed_fallback_not_ported")
    keep = rvals < 9.0
    check_rows("rle probe vs numpy", rows,
               [(float(rvals[keep].sum()), int(keep.sum()))], 1e-12)
    return n, rows, times[0], min(times[1:])


GENERIC_JOIN_QUERY = (
    "SELECT o_orderdate, count(*), sum(l_extendedprice) FROM orders "
    "JOIN lineitem ON o_orderkey = l_orderkey GROUP BY o_orderdate "
    "ORDER BY o_orderdate")
JOIN_COUNTERS = ("join_host_fallbacks", "host_fallbacks",
                 "join_device_joins", "join_build_sorts",
                 "join_build_cache_hits", "join_expand_out_rows",
                 "join_expand_probe_rows")


def join_oracle(li, orders, tpch):
    """Q3C and the generic-key join in float64 numpy: every l_orderkey is
    an orders row (keys 1..n consecutive), so a per-order lookup of
    priority, date and date filter, then `np.bincount` over lineitem."""
    import numpy as np

    names = sorted(set(orders["o_orderpriority"][:1000].tolist()))
    code = np.zeros(len(orders["o_orderkey"]), dtype=np.int64)
    for i, name in enumerate(names):
        code[orders["o_orderpriority"] == name] = i
    if int(np.bincount(code, minlength=len(names)).sum()) != len(code):
        fail("join oracle: an order priority outside the first 1000 rows")
    date = orders["o_orderdate"].astype(np.int64)
    passes = date < tpch._days("1995-03-15")
    row = li["l_orderkey"] - 1
    m = passes[row]
    g = code[row][m]
    rev = (li["l_extendedprice"] * (1 - li["l_discount"]))[m]
    cnt = np.bincount(g, minlength=len(names))
    q3c = [(names[i], int(cnt[i]),
            float(np.bincount(g, weights=rev, minlength=len(names))[i]))
           for i in range(len(names))
           if passes[code == i].any()]
    d = date[row]
    lo = int(d.min())
    dc = np.bincount(d - lo)
    ds = np.bincount(d - lo, weights=li["l_extendedprice"])
    generic = [(lo + int(i), int(dc[i]), float(ds[i]))
               for i in np.flatnonzero(dc)]
    return q3c, generic


def join_path(session, tpch, reps, profile):
    """Phase 10's runs: Q3C through `session.sql` with the counters at 0;
    (rows, first seconds, warm seconds, counter deltas, launches, peak
    device bytes, resident bytes before, profile or None)."""
    import torch

    from snappydata_tpu_torch.engine import executor
    from snappydata_tpu_torch.observability.metrics import global_registry
    from snappydata_tpu_torch.ops import group_reduce as gr

    reg = global_registry()
    before = {k: reg.counter(k) for k in JOIN_COUNTERS}
    rec = Recorder(executor.grouped_reduce, keep=1)
    executor.grouped_reduce = rec
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    gr.grouped_reduce.launches = 0
    times = []
    try:
        for _ in range(1 + reps):
            t0 = time.perf_counter()
            rows = session.sql(tpch.Q3C).rows()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    finally:
        executor.grouped_reduce = rec.fn
    launches = gr.grouped_reduce.launches
    peak = torch.cuda.max_memory_allocated()
    moved = {k: reg.counter(k) - before[k] for k in JOIN_COUNTERS}
    prof = profile_run(lambda: session.sql(tpch.Q3C).rows()) \
        if profile else None
    warm = sorted(times[1:])[len(times[1:]) // 2] if reps else times[0]
    return (rows, times[0], warm, moved, launches, rec.calls, peak,
            resident, prof)


MESH_SLOTS = 4                # phase 29: shard slots on the one card
RESIZED_SLOTS = 2             # phase 29: slots after the live resize
MESH_COUNTERS = ("mesh_shard_execs", "mesh_psum_merges",
                 "mesh_join_broadcast", "mesh_join_shuffle",
                 "mesh_exchange_bytes", "mesh_exchange_rows",
                 "mesh_exchange_cache_hits", "host_fallbacks",
                 "device_upload_bytes")


def _slot_bytes(per_dev):
    """The slot entries of `device_cache_bytes_by_device`."""
    return {k: v for k, v in sorted(per_dev.items())
            if k.startswith("slot")}


def mesh_run(session, sql, kernel, reps, what):
    """One query through the session's mesh once and `reps` times warm,
    the kernel's launches and the mesh counters read around the runs:
    (rows, first s, warm s, launches a run, counter deltas)."""
    import torch

    from snappydata_tpu_torch.observability.metrics import global_registry

    reg = global_registry()
    n0 = kernel.launches
    c0 = reg.counters(MESH_COUNTERS)
    times = []
    for _ in range(1 + reps):
        t0 = time.perf_counter()
        rows = session.sql(sql).rows()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    runs = 1 + reps
    launches = kernel.launches - n0
    moved = {k: v - c0[k] for k, v in reg.counters(MESH_COUNTERS).items()}
    if moved["mesh_shard_execs"] != runs:
        fail(f"mesh {what}: {moved['mesh_shard_execs']} per-slot lane runs "
             f"over {runs} queries")
    if launches < MESH_SLOTS * runs:
        fail(f"mesh {what}: {launches} launches of {kernel.__name__} over "
             f"{runs} runs, expected at least {MESH_SLOTS} a run")
    if moved["host_fallbacks"]:
        fail(f"mesh {what} left the device")
    warm = sorted(times[1:])[len(times[1:]) // 2] if reps else times[0]
    log(f"mesh_{what} first_s {times[0]:.4f} warm_s {warm:.4f} "
        f"launches_per_run {launches / runs:g} counters {json.dumps(moved)}")
    return rows, times[0], warm, launches, moved


def mesh_path(session, tpch, want, q3c_rows, warm, args):
    """Phase 29: lineitem and orders as phases 4 and 10 left them on a
    4-slot mesh of the one card.  Q1 and Q6 against phase 4's oracle, Q3C
    under a broadcast and a shuffle join against phase 10's rows, a live
    resize to 2 slots and Q1 again; no mesh fallback, no slot off cuda:0.
    Returns the kernels' launches over the phase's runs."""
    import torch

    from snappydata_tpu_torch import config
    from snappydata_tpu_torch.engine import mesh_exec
    from snappydata_tpu_torch.observability.metrics import global_registry
    from snappydata_tpu_torch.ops import group_reduce as gr
    from snappydata_tpu_torch.ops import kahan_reduce as kr
    from snappydata_tpu_torch.parallel.mesh import data_mesh
    from snappydata_tpu_torch.storage.device import (
        device_cache_bytes_by_device, device_cache_bytes_by_table)

    props = config.global_properties()
    reg = global_registry()
    tables = [(n, session.catalog.lookup_table(n).data)
              for n in ("lineitem", "orders")]
    props.mesh_slots = MESH_SLOTS
    props.pallas_reduce = props.pallas_group_reduce = True
    fb0 = {k: v for k, v in reg.counters_snapshot().items()
           if k.startswith("mesh_fallback_")}
    launches = {"masked_kahan_sum": 0, "grouped_reduce": 0}
    try:
        mesh = data_mesh(MESH_SLOTS)
        cards = {str(sl.device) for sl in mesh.slots}
        log(f"mesh {mesh.size} slots on {len(cards)} x "
            f"{torch.cuda.get_device_name(0)}: "
            f"{', '.join(str(sl) for sl in mesh.slots)}")
        if any(sl.device != torch.device("cuda", 0) for sl in mesh.slots):
            fail(f"a mesh slot is not on cuda:0: {mesh}")
        single = device_cache_bytes_by_table(tables)
        session.default_mesh = mesh
        rows, _f, _w, n, _m = mesh_run(session, tpch.Q1, gr.grouped_reduce,
                                       args.reps, "q1")
        check_rows("mesh Q1 vs numpy oracle", rows, want["q1"])
        launches["grouped_reduce"] += n
        q1_warm = _w
        rows, _f, _w, n, _m = mesh_run(session, tpch.Q6,
                                       kr.masked_kahan_sum, args.reps, "q6")
        check_rows("mesh Q6 vs numpy oracle", rows, want["q6"])
        launches["masked_kahan_sum"] += n
        log(f"mesh_warm_s q1 {q1_warm:.4f} q6 {_w:.4f} beside phase 4's "
            f"in-process q1 {warm['q1']:.4f} q6 {warm['q6']:.4f} (the "
            f"{MESH_SLOTS} slots share one card's SMs: the per-slot lane's "
            f"overhead, not scaling)")
        for strategy in ("broadcast", "shuffle"):
            props.mesh_join_strategy = strategy
            x0 = reg.timer("mesh_exchange")
            rows, _f, _w, n, moved = mesh_run(
                session, tpch.Q3C, gr.grouped_reduce, args.reps,
                f"q3c_{strategy}")
            check_rows(f"mesh Q3C ({strategy}) vs phase 10", rows, q3c_rows)
            launches["grouped_reduce"] += n
            if moved["mesh_join_" + strategy] != 1 + args.reps:
                fail(f"mesh Q3C did not take the {strategy} join: {moved}")
            if strategy == "shuffle":
                x1 = reg.timer("mesh_exchange")
                log(f"mesh_shuffle_exchange_s {x1[1] - x0[1]:.4f} "
                    f"exchanges {x1[0] - x0[0]} bytes "
                    f"{moved['mesh_exchange_bytes']} rows_moved "
                    f"{moved['mesh_exchange_rows']} cache_hits "
                    f"{moved['mesh_exchange_cache_hits']} layout_bytes "
                    f"{mesh_exec.mesh_layout_cache_nbytes()}")
        props.mesh_join_strategy = "auto"
        before = _slot_bytes(device_cache_bytes_by_device(tables))
        log(f"mesh_resident_bytes single_device {json.dumps(single)} "
            f"per_slot {json.dumps(before)}")
        u0 = reg.counter("device_upload_bytes")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        resized = session.resize_mesh(RESIZED_SLOTS)
        resize_s = time.perf_counter() - t0
        h2d = reg.counter("device_upload_bytes") - u0
        after = _slot_bytes(device_cache_bytes_by_device(tables))
        log(f"mesh_resize {MESH_SLOTS}->{RESIZED_SLOTS} s {resize_s:.4f} "
            f"{json.dumps(resized)} host_to_device_bytes {h2d} per_slot "
            f"{json.dumps(after)}")
        if resized["buckets_moved"] < 1 or len(after) != RESIZED_SLOTS:
            fail(f"the resize moved nothing: {resized} {after}")
        n0 = gr.grouped_reduce.launches
        t0 = time.perf_counter()
        rows = session.sql(tpch.Q1).rows()
        torch.cuda.synchronize()
        log(f"mesh_q1_after_resize s {time.perf_counter() - t0:.4f} "
            f"launches {gr.grouped_reduce.launches - n0}")
        launches["grouped_reduce"] += gr.grouped_reduce.launches - n0
        check_rows("mesh Q1 after the resize vs numpy oracle", rows,
                   want["q1"])
        fell = {k: v - fb0.get(k, 0)
                for k, v in reg.counters_snapshot().items()
                if k.startswith("mesh_fallback_") and v != fb0.get(k, 0)}
        if fell:
            fail(f"the mesh lane fell back: {fell}")
    finally:
        session.default_mesh = None
        session._mesh_ctx = None
        props.mesh_join_strategy = "auto"
        props.mesh_slots = 0
        mesh_exec.trim_layout_caches(0)
        for _n, data in tables:
            for k in [k for k in list(data._device_cache)
                      if isinstance(k[1], int)]:
                data._device_cache.pop(k, None)
    log("answers ok: Q1 / Q6 on 4 slots match the oracle, Q3C under both "
        "joins matches phase 10, Q1 after the resize matches the oracle")
    return launches


# --------------------------------------------------------------------------
# phase 30: the TPC-DS kit's eight queries on the main session
# --------------------------------------------------------------------------

TPCDS_SF = 10                 # store_sales 28,800,000 rows (the kit's sizes)
# the queries that stay on the device, in the order phase 30 runs them
# at --tpcds-sf; q6, q19 and q98 leave it (TPCDS_HOST)
TPCDS_DEVICE = ("q3", "q42", "q52", "q55", "q36")
# the queries whose GROUP BY keys are all dictionary keys with at most 64
# groups (q6: ca_state; q36: ROLLUP(i_category, i_class)'s category level):
# the grouped kernel's gate in both packages (`fast` and MAX_GROUPS,
# snappydata_tpu/engine/executor.py:2719); the rest group by INT keys
# (d_year, i_brand_id, i_manufact_id) on the generic key lane
TPCDS_GROUPED = ("q6", "q36")
# the queries the reference declines to compile on its CPU branch too
# (its routing equals the port's there: tests/test_torch_tpcds.py), with
# the engine's reason; they run on the single-threaded host lane (q6's
# GROUP BY through the host lane's device program), which took 56 - 92 s
# a run of q19 / q6 at SF 10, so phase 30 runs them once each over the
# kit at TPCDS_HOST_SF
TPCDS_HOST = {"q19": "cross-dictionary string comparison",
              "q6": "node Aggregate",
              "q98": "node Aggregate"}
TPCDS_HOST_SF = 1             # store_sales 2,880,000 rows
TPCDS_TABLES = ("store_sales", "date_dim", "item", "customer",
                "customer_address", "store")
TPCDS_DATE0 = 2_450_000       # d_date_sk of the first generated day


class _Capture:
    """The session `tpcds.load_tpcds` writes through, keeping the arrays
    it inserts (the oracle's input: nothing is generated twice)."""

    def __init__(self, session):
        self.session = session
        self.arrays = {}

    def sql(self, text):
        return self.session.sql(text)

    def insert_arrays(self, table, arrays):
        self.arrays[table] = dict(zip(_TPCDS_COLS[table], arrays))
        t0 = time.perf_counter()
        out = self.session.insert_arrays(table, list(arrays))
        log(f"tpcds_load {table} rows {len(arrays[0])} s "
            f"{time.perf_counter() - t0:.3f}")
        return out


_TPCDS_COLS = {
    "date_dim": ("d_date_sk", "d_year", "d_moy", "d_qoy", "d_dow"),
    "item": ("i_item_sk", "i_brand_id", "i_brand", "i_category_id",
             "i_category", "i_class_id", "i_class", "i_manufact_id",
             "i_manager_id", "i_current_price"),
    "customer": ("c_customer_sk", "c_current_addr_sk", "c_birth_month"),
    "customer_address": ("ca_address_sk", "ca_gmt_offset", "ca_state"),
    "store": ("s_store_sk", "s_gmt_offset", "s_state"),
    "store_sales": ("ss_sold_date_sk", "ss_item_sk", "ss_customer_sk",
                    "ss_store_sk", "ss_quantity", "ss_ext_sales_price",
                    "ss_sales_price", "ss_net_profit", "ss_coupon_amt",
                    "ss_list_price")}


def _grouped(keys, weights, how="sum"):
    """{key tuple: (sum of each weight, ...)} over the rows of `keys`
    (equal-length arrays; small after the queries' filters)."""
    import pandas as pd

    frame = pd.DataFrame({f"k{i}": k for i, k in enumerate(keys)}
                         | {f"w{i}": w for i, w in enumerate(weights)})
    g = frame.groupby([f"k{i}" for i in range(len(keys))], sort=False)
    agg = g.sum() if how == "sum" else g.size().to_frame()
    def plain(xs):
        return tuple(x.item() if hasattr(x, "item") else x for x in xs)

    return {plain(k if isinstance(k, tuple) else (k,)): plain(row)
            for k, row in zip(agg.index, agg.itertuples(index=False))}


def tpcds_oracle(t, queries):
    """`queries` of the kit in float64 numpy / pandas over the generated
    arrays `t` (table -> column -> array): {query: (rows in ORDER BY
    order before the LIMIT, the tolerance of each float column)}.  Foreign
    keys index the dimensions directly (their surrogate keys are 1 .. n,
    d_date_sk from TPCDS_DATE0); each filter runs on numbers (string
    predicates as masks over the small dimension tables) before a string
    column is gathered."""
    import numpy as np

    ss, dd, it = t["store_sales"], t["date_dim"], t["item"]
    cu, ca, st = t["customer"], t["customer_address"], t["store"]
    di = ss["ss_sold_date_sk"] - TPCDS_DATE0
    ii = ss["ss_item_sk"] - 1
    year, moy = dd["d_year"][di], dd["d_moy"][di]
    mgr = it["i_manager_id"][ii]
    price = ss["ss_ext_sales_price"]
    out = {}

    def item_col(name, idx):
        return it[name][ii[idx]]

    def rows_of(m, keys, order):
        idx = np.flatnonzero(m)
        agg = _grouped([k(idx) for k in keys], [price[idx]])
        rows = [k + (v[0],) for k, v in agg.items()]
        rows.sort(key=order)
        return rows, 1e-6

    def yr(idx):
        return year[idx]

    def brand_id(idx):
        return item_col("i_brand_id", idx)

    def brand(idx):
        return item_col("i_brand", idx)

    if "q3" in queries:
        m = (it["i_manufact_id"][ii] == 100) & (moy == 11)
        out["q3"] = rows_of(m, [yr, brand_id, brand],
                            lambda r: (r[0], -r[3], r[1]))
    m = (mgr == 1) & (moy == 11) & (year == 2000)
    if "q42" in queries:
        out["q42"] = rows_of(m, [yr, lambda i: item_col("i_category_id", i),
                                 lambda i: item_col("i_category", i)],
                             lambda r: (-r[3], r[0], r[1], r[2]))
    if "q52" in queries:
        out["q52"] = rows_of(m, [yr, brand_id, brand],
                             lambda r: (r[0], -r[3], r[1]))
    if "q55" in queries:
        m = (mgr == 28) & (moy == 11) & (year == 1999)
        out["q55"] = rows_of(m, [brand_id, brand], lambda r: (-r[2], r[0]))
    ci = ss["ss_customer_sk"] - 1
    si = ss["ss_store_sk"] - 1
    if "q19" in queries:
        states, codes = np.unique(np.concatenate(
            [ca["ca_state"], st["s_state"]]), return_inverse=True)
        ca_code, st_code = codes[:len(ca["ca_state"])], \
            codes[len(ca["ca_state"]):]
        m = (mgr >= 8) & (mgr <= 40) & (moy == 11)
        idx = np.flatnonzero(m)
        ai = cu["c_current_addr_sk"][ci[idx]] - 1
        m[idx] = ca_code[ai] != st_code[si[idx]]
        out["q19"] = rows_of(m, [brand_id, brand,
                                 lambda i: item_col("i_manufact_id", i)],
                             lambda r: (-r[3], r[0]))
    if "q6" in queries:
        # items priced over 1.2x their category's average price
        cp = it["i_current_price"]
        _cats, cat_code = np.unique(it["i_category"], return_inverse=True)
        avg = np.bincount(cat_code, weights=cp) / np.bincount(cat_code)
        hot = cp > 1.2 * avg[cat_code]
        idx = np.flatnonzero((year == 2000) & hot[ii])
        ai = cu["c_current_addr_sk"][ci[idx]] - 1
        cnt = _grouped([ca["ca_state"][ai]], [], how="size")
        q6 = [(k[0], int(v[0])) for k, v in cnt.items() if v[0] >= 10]
        q6.sort(key=lambda r: (r[1], r[0]))
        out["q6"] = (q6, 0.0)
    if "q36" in queries:
        # ROLLUP(i_category, i_class) of sum(net_profit) / sum(price); the
        # ratio's bound follows from its two sums' (net_profit is mixed
        # sign: 1e-6 * sum(|v|); the price sum is same-sign: rel 1e-6)
        in_state = np.isin(st["s_state"], ["CA", "TX"])
        idx = np.flatnonzero((year == 2001) & in_state[si])
        cat, cls = item_col("i_category", idx), item_col("i_class", idx)
        prof, pr = ss["ss_net_profit"][idx], price[idx]
        q36 = []
        for keys in ([cat, cls], [cat], []):
            if keys:
                agg = _grouped(keys, [prof, pr, np.abs(prof)])
            else:
                agg = {(): (prof.sum(), pr.sum(), np.abs(prof).sum())}
            for k, (a, b, absa) in agg.items():
                k = tuple(k) + (None,) * (2 - len(k))
                tol = 1e-6 * (absa + abs(a / b) * b) / b
                q36.append(((a / b,) + k, tol))
        q36.sort(key=lambda r: (r[0][0], r[0][1] or "", r[0][2] or ""))
        out["q36"] = ([r for r, _t in q36], {r: t for r, t in q36})
    if "q98" in queries:
        # per-item revenue over its class's total, in percent
        in_cat = np.isin(it["i_category"], ["cat#1", "cat#2", "cat#3"])
        idx = np.flatnonzero(in_cat[ii] & (year == 1999) & (moy == 2))
        per = _grouped([ss["ss_item_sk"][idx], item_col("i_class", idx)],
                       [price[idx]])
        tot = {}
        for (_sk, c), (v,) in per.items():
            tot[c] = tot.get(c, 0.0) + v
        q98 = [(sk, c, v, v * 100.0 / tot[c])
               for (sk, c), (v,) in per.items()]
        q98.sort(key=lambda r: (r[1], r[3]))
        out["q98"] = (q98, 2e-6)
    return out


def _cmp_key(a, b, tol):
    """-1, 0 or 1: tuple `a` against `b`, floats equal within `tol`
    relative, None first (ascending order puts NULLs first)."""
    for x, y in zip(a, b):
        if x is None or y is None:
            if x is None and y is None:
                continue
            return -1 if x is None else 1
        if isinstance(x, float) or isinstance(y, float):
            if abs(x - y) <= tol * max(abs(x), abs(y)):
                continue
        if x != y:
            return -1 if x < y else 1
    return 0


def check_tpcds(q, got, want):
    """`got` (the query's rows, LIMIT 100) against the oracle's ordered
    rows: the row count; each row's key columns exact and its float
    columns within the query's tolerance of the oracle's row of that key;
    the rows in ORDER BY order and the LIMIT's cut where the oracle puts
    it (both up to ties within the tolerance)."""
    rows, tol = want
    if len(got) != min(100, len(rows)):
        fail(f"TPC-DS {q}: {len(got)} rows, the oracle {min(100, len(rows))}")

    def key(r):
        return tuple(x for x in r if not isinstance(x, float))

    by_key = {key(r): r for r in rows}
    order = {key(r): i for i, r in enumerate(rows)}
    for g in got:
        g = tuple(g)
        w = by_key.get(key(g))
        if w is None:
            fail(f"TPC-DS {q}: row {g} has no oracle row of its key")
        t = tol[w] if isinstance(tol, dict) else tol
        for a, b in zip(g, w):
            if isinstance(b, float):
                if a is None or abs(a - b) > t * abs(b) + 1e-9:
                    fail(f"TPC-DS {q}: {g} against the oracle's {w} (tol {t})")
            elif a != b:
                fail(f"TPC-DS {q}: {g} != {w}")
    # order: each got row's oracle position, compared with tolerance
    pos = [order[key(tuple(g))] for g in got]
    t = max(tol.values()) if isinstance(tol, dict) else max(tol, 1e-12)
    for i in range(1, len(pos)):
        if pos[i] < pos[i - 1] \
                and _cmp_key(rows[pos[i]], rows[pos[i - 1]], t) != 0:
            fail(f"TPC-DS {q}: rows {got[i - 1]} and {got[i]} out of order")
    last = max(pos) if pos else -1
    seen = set(pos)
    for i in (i for i in range(last) if i not in seen):
        if _cmp_key(rows[i], rows[last], t) != 0:
            fail(f"TPC-DS {q}: the oracle's row {rows[i]} is missing")


def tpcds_load(session, sf, seed):
    """`tpcds.load_tpcds` at `sf` on `session`, timed per table; the
    generated arrays (table -> column -> array)."""
    from snappydata_tpu_torch.utils import tpcds

    sizes = tpcds.table_sizes(sf)
    log(f"tpcds sf {sf} sizes {json.dumps(sizes)}")
    cap = _Capture(session)
    t0 = time.perf_counter()
    tpcds.load_tpcds(cap, sf=sf, seed=seed)
    load_s = time.perf_counter() - t0
    n_ss = sizes["store_sales"]
    if len(cap.arrays["store_sales"]["ss_item_sk"]) != n_ss:
        fail("TPC-DS: store_sales holds another row count than "
             "table_sizes gives")
    log(f"tpcds_load_s {load_s:.3f} sf {sf} (generation included) "
        f"store_sales rows_per_s {n_ss / load_s:.0f}")
    return cap.arrays


def tpcds_runs(session, queries, want, reps, out):
    """Each of `queries` through `session.sql` once and `reps` times warm
    (`timed_query`: launch counters at 0 before each query), its lane,
    launches and counters logged, checked against `want`; adds its
    launches, counter deltas and the first inputs each kernel received
    to `out`."""
    from snappydata_tpu_torch.observability import tracing
    from snappydata_tpu_torch.utils import tpcds

    runs = 1 + reps
    for q in queries:
        rows, f_s, w_s, moved, lc, calls, peak, _res = \
            timed_query(session, tpcds.QUERIES[q], reps)
        reasons = set()
        last = tracing.ring().last()
        stack = [last.root] if last is not None else []
        while stack:
            sp = stack.pop()
            if sp.name == "host_fallback" and sp.attrs.get("reason"):
                reasons.add(sp.attrs["reason"])
            stack.extend(sp.children)
        lane = "device" if not moved["host_fallbacks"] else \
            f"host ({'; '.join(sorted(reasons)) or 'no reason'})"
        log(f"tpcds {q} rows {len(rows)} first_s {f_s:.4f}"
            + (f" warm_s {w_s:.4f}" if reps else "")
            + f" lane {lane} launches_per_run "
            f"{json.dumps({k: v / runs for k, v in lc.items()})} counters "
            f"{json.dumps(moved)} peak_device_bytes {peak}")
        if (q in TPCDS_HOST) != bool(moved["host_fallbacks"]) or (
                q in TPCDS_HOST and not any(TPCDS_HOST[q] in r
                                            for r in reasons)):
            fail(f"TPC-DS {q} took the {lane} lane; the reference's CPU "
                 f"branch routes it to the "
                 f"{'host' if q in TPCDS_HOST else 'device'}")
        if q in TPCDS_GROUPED and lc["grouped_reduce"] < runs:
            fail(f"grouped_reduce launched {lc['grouped_reduce']} times "
                 f"over TPC-DS {q}'s {runs} runs")
        if moved["join_host_fallbacks"]:
            fail(f"TPC-DS {q} joined on the host: {moved}")
        for k in out["launches"]:
            out["launches"][k] += lc[k]
            if k not in out["calls"] and calls[k]:
                out["calls"][k] = (q, calls[k])
        for k in moved:
            out["moved"][k] = out["moved"].get(k, 0) + moved[k]
        check_tpcds(q, rows, want[q])
        log(f"tpcds {q} first_rows {json.dumps(rows[:3], default=str)}")


def tpcds_path(session, args):
    """Phase 30: load the TPC-DS kit at `args.tpcds_sf` on `session`, run
    its device-lane queries once and --reps times warm with both kernel
    knobs on, reload the kit at TPCDS_HOST_SF and run the host-lane ones
    once, hold each answer against the oracle and the kernels against
    their plain versions on the first inputs the phase handed them;
    returns the phase's launches.  The kit's tables are dropped at the
    end."""
    from snappydata_tpu_torch import config, native

    props = config.global_properties()
    props.pallas_reduce = True
    props.pallas_group_reduce = True
    out = {"launches": {"grouped_reduce": 0, "masked_kahan_sum": 0},
           "calls": {}, "moved": {}}
    for sf, queries, reps in ((args.tpcds_sf, TPCDS_DEVICE, args.reps),
                              (TPCDS_HOST_SF, tuple(TPCDS_HOST), 0)):
        arrays = tpcds_load(session, sf, args.seed)
        t0 = time.perf_counter()
        want = tpcds_oracle(arrays, queries)
        log(f"tpcds_oracle_s {time.perf_counter() - t0:.3f} sf {sf}")
        del arrays
        tpcds_runs(session, queries, want, reps, out)
        for table in TPCDS_TABLES:
            session.sql(f"DROP TABLE {table}")
    log(f"tpcds_launches {json.dumps(out['launches'])} counters "
        f"{json.dumps(out['moved'])}")
    for name, phase in (("grouped_reduce", grouped_phase),
                        ("masked_kahan_sum", kahan_phase)):
        if name not in out["calls"]:
            fail(f"{name} did not launch on the TPC-DS queries")
        q, calls = out["calls"][name]
        log(f"kernel {name} on TPC-DS {q} "
            f"{json.dumps(phase(calls, args.reps))}")
    fb = native.counters()["native_fallbacks"]
    log(f"native_encoder loaded {native.native_available()} "
        f"native_fallbacks {fb} so {native.SO}")
    if not native.native_available() or fb:
        fail("the native string encoder is not loaded, or ingest fell "
             f"back to the plain encoder ({fb} calls)")
    log("answers ok: the eight TPC-DS queries match the oracle")
    return out["launches"]


def build_sort_ms(session, reps):
    """The build side's sort alone: lineitem's l_orderkey plate encoded
    as the join encodes it, sorted stably, CUDA-event mean."""
    import torch

    from snappydata_tpu_torch.ops import join as dj
    from snappydata_tpu_torch.storage.device import build_device_table

    data = session.catalog.lookup_table("lineitem").data
    dt = build_device_table(data, [0], session.device, code_ok=False)
    keys = dj.encode_build_keys([(dt.columns[0].reshape(-1), None)],
                                dt.valid.reshape(-1), None)
    return cuda_ms(lambda: torch.sort(keys, stable=True), reps), \
        int(keys.numel())


Q1_COLS = ("l_quantity", "l_extendedprice", "l_discount", "l_tax",
           "l_returnflag", "l_linestatus", "l_shipdate")
Q6_COLS = ("l_quantity", "l_extendedprice", "l_discount", "l_shipdate")
DEC_COLS = ("l_quantity", "l_extendedprice", "l_discount", "l_tax")
MIB = 1 << 20
DISTINCT_QUERY = (
    "SELECT l_returnflag, l_linestatus, count(DISTINCT l_suppkey) "
    "FROM lineitem GROUP BY 1, 2 ORDER BY 1, 2")


def tile_plan(session, table, cols, budget):
    """(units, bytes per unit, units per tile, tiles) of `table`'s scan
    over `cols` under `budget`, by the session's own unit math."""
    from snappydata_tpu_torch import config
    from snappydata_tpu_torch.storage.device import scan_unit_count

    info = session.catalog.describe(table)
    with config.device_scope(session.device):
        per = 1 + sum(session._decoded_col_width(info.schema.field(c))
                      for c in cols)
    units = scan_unit_count(info.data)
    unit_bytes = info.data.capacity * per
    tile_units = max(1, budget // unit_bytes)
    if tile_units > 1:
        tile_units = 1 << (tile_units.bit_length() - 1)
    return units, unit_bytes, tile_units, -(-units // tile_units)


def pinned_h2d_gb_per_s(nbytes, reps):
    """Host-to-device copy rate from pinned memory, CUDA-event timed."""
    import torch

    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    ms = cuda_ms(lambda: dev.copy_(host, non_blocking=True), reps)
    return nbytes / ms / 1e6


def tiled_path(session, tpch, reps, budget, profile):
    """Phase 11's runs: both kernel lanes on, lineitem's device cache
    dropped, the counters at 0, Q1 and Q6 through the tiled lane once and
    `reps` times warm.  The
    last run keeps the kernel inputs of its first and last tiles, so the
    peak device memory is read before it."""
    import torch

    from snappydata_tpu_torch import config
    from snappydata_tpu_torch.engine import executor
    from snappydata_tpu_torch.observability.metrics import (TILE_COUNTERS,
                                                            global_registry)
    from snappydata_tpu_torch.ops import group_reduce as gr
    from snappydata_tpu_torch.ops import kahan_reduce as kr

    props = config.global_properties()
    data = session.catalog.lookup_table("lineitem").data
    reg = global_registry()
    names = TILE_COUNTERS + ("host_fallbacks",)
    props.pallas_reduce = True
    props.pallas_group_reduce = True
    props.scan_tile_bytes = budget
    data._device_cache.clear()
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = reg.counters(names)
    kr.masked_kahan_sum.launches = 0
    gr.grouped_reduce.launches = 0
    rec_k = Recorder(executor.masked_kahan_sum, ends=True)
    rec_g = Recorder(executor.grouped_reduce, ends=True)
    times = {"q1": [], "q6": []}
    uploads = {"q1": [], "q6": []}
    rows = {}
    peak = None
    try:
        for run in range(1 + reps):
            if run == reps and reps:
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated() - resident
                executor.masked_kahan_sum = rec_k
                executor.grouped_reduce = rec_g
            for q, sql in (("q1", tpch.Q1), ("q6", tpch.Q6)):
                u0 = reg.counter("device_upload_bytes")
                t0 = time.perf_counter()
                rows[q] = session.sql(sql).rows()
                torch.cuda.synchronize()
                times[q].append(time.perf_counter() - t0)
                uploads[q].append(reg.counter("device_upload_bytes") - u0)
    finally:
        executor.masked_kahan_sum = rec_k.fn
        executor.grouped_reduce = rec_g.fn
    if peak is None:
        peak = torch.cuda.max_memory_allocated() - resident
    launches = {"masked_kahan_sum": kr.masked_kahan_sum.launches,
                "grouped_reduce": gr.grouped_reduce.launches}
    after = reg.counters(names)
    moved = {k: after[k] - before[k] for k in names}
    prof = profile_run(lambda: session.sql(tpch.Q1).rows()) \
        if profile else None
    props.scan_tile_bytes = 0
    return (rows, times, uploads, moved, launches, peak, resident,
            rec_k.calls, rec_g.calls, prof)


def dec_oracle(li, tpch):
    """Q1's exact slots over DECIMAL(15,2) columns from int64 cents: per
    (returnflag, linestatus) the cent sums of l_quantity and
    l_extendedprice, with the counts."""
    from decimal import Decimal

    import numpy as np

    flag, status = li["l_returnflag"], li["l_linestatus"]
    code = (flag == "N").astype(np.int64) + 2 * (flag == "R")
    code = code * 2 + (status == "O")
    m = li["l_shipdate"] <= tpch._days("1998-12-01") - 90
    qty = np.round(li["l_quantity"] * 100).astype(np.int64)
    price = np.round(li["l_extendedprice"] * 100).astype(np.int64)
    out = []
    for c in range(6):
        sel = m & (code == c)
        n = int(sel.sum())
        if n:
            out.append(("ANR"[c // 2], "FO"[c % 2],
                        Decimal(int(qty[sel].sum())).scaleb(-2),
                        Decimal(int(price[sel].sum())).scaleb(-2), n))
    return out


def check_dec_q1(what, got, exact, floats):
    """Exact slots digit for digit, float slots within rel 1e-6."""
    from decimal import Decimal

    if len(got) != len(exact):
        fail(f"{what}: {len(got)} rows, expected {len(exact)}")
    for g, e, f in zip(got, exact, floats):
        if g[:2] != e[:2] or g[9] != e[4]:
            fail(f"{what}: keys/count {g[:2] + (g[9],)} != "
                 f"{e[:2] + (e[4],)}")
        for i, want in ((2, e[2]), (3, e[3])):
            if not isinstance(g[i], Decimal) or str(g[i]) != str(want):
                fail(f"{what}: exact slot {i} {g[i]!r} != {want!r}")
        check_rows(f"{what} float slots", [g[4:9]], [f[4:9]])


def decimal_path(session, tpch, li, reps, budget, profile):
    """Phase 12: lineitem_dec loaded from the generated rows; Q1 / Q6
    untiled, Q1 tiled at `budget` once and `reps` times warm, the
    overflow probe."""
    from decimal import Decimal

    import numpy as np
    import torch

    from snappydata_tpu_torch import config
    from snappydata_tpu_torch.observability.metrics import (TILE_COUNTERS,
                                                            global_registry)

    props = config.global_properties()
    reg = global_registry()
    ddl = tpch.LINEITEM_DDL.replace("TABLE lineitem", "TABLE lineitem_dec")
    for c in DEC_COLS:
        ddl = ddl.replace(f"{c} DOUBLE", f"{c} DECIMAL(15,2)")
    session.sql(ddl)
    t0 = time.perf_counter()
    session.insert_arrays("lineitem_dec", list(li.values()))
    load_s = time.perf_counter() - t0
    q1 = tpch.Q1.replace("FROM lineitem", "FROM lineitem_dec")
    q6 = tpch.Q6.replace("FROM lineitem", "FROM lineitem_dec")
    fb = reg.counter("host_fallbacks")
    out = {"load_s": load_s}
    for name, q in (("q1", q1), ("q6", q6)):
        times = []
        for _ in range(1 + reps):
            t0 = time.perf_counter()
            rows = session.sql(q).rows()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        out[name] = rows
        out[name + "_first_s"] = times[0]
        out[name + "_warm_s"] = sorted(times[1:])[len(times[1:]) // 2] \
            if reps else times[0]
    if reg.counter("host_fallbacks") != fb:
        fail("decimal Q1/Q6 left the device")
    want = oracle(li, tpch)
    check_dec_q1("decimal Q1", out["q1"], dec_oracle(li, tpch),
                 want["q1"])
    check_rows("decimal Q6 vs numpy oracle", [(float(out["q6"][0][0]),)],
               want["q6"])
    # Q1 tiled at phase 11's budget: the per-tile int64 partials merge on
    # the device; the merge hands them back through float64 partial
    # columns, so the exact slots compare at the column scale
    props.scan_tile_bytes = budget
    before = reg.counters(TILE_COUNTERS)
    times = []
    for _ in range(1 + reps):
        t0 = time.perf_counter()
        tiled = session.sql(q1).rows()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    after = reg.counters(TILE_COUNTERS)
    out["q1_tiled_counters"] = {k: after[k] - before[k]
                                for k in TILE_COUNTERS}
    out["q1_tiled_prof"] = profile_run(lambda: session.sql(q1).rows()) \
        if profile else None
    props.scan_tile_bytes = 0
    out["q1_tiled_first_s"] = times[0]
    out["q1_tiled_warm_s"] = sorted(times[1:])[len(times[1:]) // 2] \
        if reps else times[0]
    out["q1_tiles"] = out["q1_tiled_counters"]["scan_tiles"] // len(times)
    if out["q1_tiles"] < 2 \
            or not out["q1_tiled_counters"]["scan_tile_device_merges"] \
            or out["q1_tiled_counters"]["scan_tile_host_merges"]:
        fail(f"decimal Q1 did not run the tiled device merge "
             f"({out['q1_tiled_counters']})")
    if reg.counter("host_fallbacks") != fb:
        fail("tiled decimal Q1 left the device")
    cents = Decimal("0.01")
    for t, u in zip(tiled, out["q1"]):
        for i in (2, 3):
            if Decimal(repr(t[i])).quantize(cents) != u[i]:
                fail(f"tiled decimal Q1 slot {i}: {t[i]!r} != untiled "
                     f"{u[i]!r}")
        if (t[:2], t[9]) != (u[:2], u[9]):
            fail(f"tiled decimal Q1 keys/count {t} != {u}")
    # the overflow probe: 5 x 9.9e17 at scale 0, max|v| * count = 4.95e18
    # >= 2^62, so the int64 guard must reroute to the host path
    session.sql("CREATE TABLE dec_probe (v DECIMAL(18,0)) USING column")
    session.insert_arrays("dec_probe", [np.full(5, 9.9e17)])
    fb = reg.counter("host_fallbacks")
    got = session.sql("SELECT sum(v) FROM dec_probe").rows()[0][0]
    if reg.counter("host_fallbacks") != fb + 1:
        fail("the decimal overflow probe did not reroute to the host path")
    if got != Decimal(495) * Decimal(10) ** 16:
        fail(f"the decimal overflow probe answered {got!r}")
    out["probe"] = str(got)
    return out


def distinct_path(session, li, reps):
    """Phase 13's count(DISTINCT) over lineitem against np.unique."""
    import numpy as np
    import torch

    from snappydata_tpu_torch.observability.metrics import global_registry

    reg = global_registry()
    fb = reg.counter("host_fallbacks")
    times = []
    for _ in range(1 + reps):
        t0 = time.perf_counter()
        rows = session.sql(DISTINCT_QUERY).rows()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    if reg.counter("host_fallbacks") != fb:
        fail("count(DISTINCT) left the device")
    flag, status = li["l_returnflag"], li["l_linestatus"]
    code = ((flag == "N").astype(np.int64) + 2 * (flag == "R")) * 2 \
        + (status == "O")
    pairs = np.unique(code * (1 << 32) + li["l_suppkey"])
    per = np.bincount(pairs >> 32, minlength=6)
    want = [("ANR"[c // 2], "FO"[c % 2], int(per[c]))
            for c in range(6) if per[c]]
    if rows != want:
        fail(f"count(DISTINCT) {rows} != numpy {want}")
    warm = sorted(times[1:])[len(times[1:]) // 2] if reps else times[0]
    return rows, times[0], warm


def strategy_timing(calls, reps):
    """Phase 13's matmul against scatter on one Q1 tile's float sums: the
    grouped kernel's inputs of the first (full) tile, rounded to integers
    so that both strategies must agree bit for bit."""
    import torch

    from snappydata_tpu_torch.ops import reduction

    if not calls:
        fail("no Q1 tile inputs for the strategy timing")
    ops, gidx, nseg = calls[0]
    G = nseg - 1
    cols = [torch.where(w, v, 0).double().round() for k, v, w in ops
            if k == "sum"] + [w.double() for k, _v, w in ops
                              if k == "count"]
    n = gidx.numel()
    onehot = reduction.onehot_bytes(n, G, torch.float64)
    if onehot > reduction.MATMUL_ONEHOT_MAX_BYTES:
        fail(f"one Q1 tile's one-hot ({onehot} B) passes the matmul bound")
    mm = reduction.packed_sum(cols, gidx, G, "matmul")
    sc = reduction.packed_sum(cols, gidx, G, "scatter")
    torch.cuda.synchronize()
    if not torch.equal(mm, sc):
        fail(f"matmul {mm.tolist()} != scatter {sc.tolist()}")
    return {"rows": n, "groups": G, "columns": len(cols),
            "onehot_bytes": onehot,
            "auto": reduction.resolve_strategy("auto", "cuda", G, n, "fsum",
                                               torch.float64),
            "matmul_ms": cuda_ms(
                lambda: reduction.packed_sum(cols, gidx, G, "matmul"),
                reps * 3),
            "scatter_ms": cuda_ms(
                lambda: reduction.packed_sum(cols, gidx, G, "scatter"),
                reps * 3)}


SUBQUERY_COUNTERS = ("host_fallbacks", "join_host_fallbacks",
                     "join_device_joins", "join_build_sorts",
                     "join_build_cache_hits")
# GROUP BY a date part and a string prefix.  The prefix is two characters:
# substr(l_shipmode, 1, 1) folds 'RAIL' and 'REG AIR' into one value, and
# a derived group key whose values repeat takes the host path in both
# packages (grouping runs on dictionary codes)
FUNCTIONS_QUERY = (
    "SELECT year(l_shipdate), substr(l_shipmode, 1, 2), "
    "sum(abs(l_quantity - 25)), count(*) FROM lineitem GROUP BY 1, 2")


def timed_query(session, sql, reps):
    """`sql` through `session.sql` once and `reps` times warm, with the
    two kernels' launch counters set to 0 just before and read just
    after; (rows, first s, warm s, counter deltas, launches, the inputs of
    each kernel's last call, peak device bytes, resident bytes before)."""
    import torch

    from snappydata_tpu_torch.engine import executor
    from snappydata_tpu_torch.observability.metrics import global_registry
    from snappydata_tpu_torch.ops import group_reduce as gr
    from snappydata_tpu_torch.ops import kahan_reduce as kr

    reg = global_registry()
    before = {k: reg.counter(k) for k in SUBQUERY_COUNTERS}
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rec = {"grouped_reduce": Recorder(executor.grouped_reduce, ends=True),
           "masked_kahan_sum": Recorder(executor.masked_kahan_sum,
                                        ends=True)}
    executor.grouped_reduce = rec["grouped_reduce"]
    executor.masked_kahan_sum = rec["masked_kahan_sum"]
    gr.grouped_reduce.launches = 0
    kr.masked_kahan_sum.launches = 0
    times = []
    try:
        for _ in range(1 + reps):
            t0 = time.perf_counter()
            rows = session.sql(sql).rows()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    finally:
        executor.grouped_reduce = rec["grouped_reduce"].fn
        executor.masked_kahan_sum = rec["masked_kahan_sum"].fn
    launches = {"grouped_reduce": gr.grouped_reduce.launches,
                "masked_kahan_sum": kr.masked_kahan_sum.launches}
    calls = {k: r.calls[-1:] for k, r in rec.items()}
    peak = torch.cuda.max_memory_allocated()
    moved = {k: reg.counter(k) - before[k] for k in SUBQUERY_COUNTERS}
    warm = sorted(times[1:])[len(times[1:]) // 2] if reps else times[0]
    return rows, times[0], warm, moved, launches, calls, peak, resident


def value_codes(arr, sample=1000):
    """(sorted distinct values, int64 code per row) of an object array
    whose distinct values all occur in its first `sample` rows."""
    import numpy as np

    names = sorted(set(arr[:sample].tolist()))
    code = np.full(len(arr), -1, dtype=np.int64)
    for i, name in enumerate(names):
        code[arr == name] = i
    if (code < 0).any():
        fail("oracle: a value outside the first rows of its column")
    return names, code


def q4_oracle(li, orders, tpch):
    import numpy as np

    late = li["l_commitdate"] < li["l_receiptdate"]
    has = np.zeros(len(orders["o_orderkey"]) + 1, dtype=np.bool_)
    has[li["l_orderkey"][late]] = True
    od = orders["o_orderdate"]
    m = (od >= tpch._days("1993-07-01")) & (od < tpch._days("1993-10-01")) \
        & has[orders["o_orderkey"]]
    names, code = value_codes(orders["o_orderpriority"])
    cnt = np.bincount(code[m], minlength=len(names))
    return [(names[i], int(cnt[i])) for i in range(len(names)) if cnt[i]]


def q22_oracle(cust, orders):
    import numpy as np

    nat, bal = cust["c_nationkey"], cust["c_acctbal"]
    sel = np.isin(nat, [1, 3, 5, 7])
    avg = bal[sel & (bal > 0.0)].mean()
    has = np.zeros(len(cust["c_custkey"]) + 1, dtype=np.bool_)
    has[orders["o_custkey"]] = True
    keep = sel & (bal > avg) & ~has[cust["c_custkey"]]
    cnt = np.bincount(nat[keep], minlength=25)
    tot = np.bincount(nat[keep], weights=bal[keep], minlength=25)
    return [(k, int(cnt[k]), float(tot[k])) for k in range(25) if cnt[k]]


def q18_oracle(li, orders, cust):
    """(the IN subquery's length, the top 100 rows, the 100th price)."""
    import numpy as np

    per = np.bincount(li["l_orderkey"], weights=li["l_quantity"],
                      minlength=len(orders["o_orderkey"]) + 1)
    big = np.flatnonzero(per > 150)
    row = big - 1
    ck = orders["o_custkey"][row]
    price = orders["o_totalprice"][row]
    order = np.lexsort((orders["o_orderdate"][row], -price))[:100]
    rows = {int(big[i]): (str(cust["c_name"][ck[i] - 1]), int(ck[i]),
                          int(big[i]), int(orders["o_orderdate"][row[i]]),
                          float(price[i]), float(per[big[i]]))
            for i in order}
    return len(big), rows, float(price[order[-1]])


def functions_oracle(li):
    import numpy as np
    import pandas as pd

    year = li["l_shipdate"].astype("datetime64[D]").astype(
        "datetime64[Y]").astype(np.int64) + 1970
    codes, uniq = pd.factorize(li["l_shipmode"])
    prefix = sorted({str(u)[:2] for u in uniq})
    pcode = np.array([prefix.index(str(u)[:2]) for u in uniq])[codes]
    lo = int(year.min())
    key = (year - lo) * len(prefix) + pcode
    cnt = np.bincount(key)
    tot = np.bincount(key, weights=np.abs(li["l_quantity"] - 25))
    return [(lo + int(k) // len(prefix), prefix[int(k) % len(prefix)],
             float(tot[k]), int(cnt[k])) for k in np.flatnonzero(cnt)]


def subquery_path(session, tpch, li, orders, args):
    """Phase 14: Q4, Q22 and the functions query at --sf, Q18 at SF 1 on
    its own session; returns the two kernels' launches over the phase."""
    import torch

    from snappydata_tpu_torch import SnappySession, config
    from snappydata_tpu_torch.catalog import Catalog

    props = config.global_properties()
    props.pallas_reduce = True
    props.pallas_group_reduce = True
    total = {"grouped_reduce": 0, "masked_kahan_sum": 0}

    def run(name, s, sql, reps, expect):
        rows, first, warm, moved, launches, calls, peak, resident = \
            timed_query(s, sql, reps)
        log(f"{name}_counters {json.dumps(moved)} launches "
            f"{json.dumps(launches)}")
        log(f"{name} first_s {first:.4f} warm_s {warm:.4f} "
            f"peak_device_bytes {peak} resident_before_bytes {resident}")
        if moved["host_fallbacks"] or moved["join_host_fallbacks"]:
            fail(f"{name} left the device: {moved}")
        runs = 1 + reps
        if moved["join_device_joins"] != expect["joins"] * runs:
            fail(f"{name} ran {moved['join_device_joins']} device joins "
                 f"over {runs} runs, expected {expect['joins']} a run")
        for k in ("grouped_reduce", "masked_kahan_sum"):
            if expect.get(k) and launches[k] < runs:
                fail(f"{k} launched {launches[k]} times over {name}'s "
                     f"{runs} runs")
            total[k] += launches[k]
        # each kernel the query must launch, against its plain version on
        # the inputs of its last (warm) call; these launches come after
        # the counters were read
        if expect.get("grouped_reduce"):
            log(f"kernel grouped_reduce on {name} " + json.dumps(
                grouped_phase(calls["grouped_reduce"], args.reps)))
        if expect.get("masked_kahan_sum"):
            log(f"kernel masked_kahan_sum on {name} " + json.dumps(
                kahan_phase(calls["masked_kahan_sum"], args.reps)))
        del calls
        if args.profile:
            log(f"profile {name} " + json.dumps(profile_run(
                lambda: s.sql(sql).rows())))
        return rows

    # Q4: EXISTS -> a semi join of orders against late lineitems, then a
    # five-group count through the grouped kernel
    rows = run("q4", session, tpch.Q4, args.reps,
               {"joins": 1, "grouped_reduce": True})
    want = q4_oracle(li, orders, tpch)
    if rows != want:
        fail(f"Q4 {rows} != numpy {want}")
    log(f"q4 {json.dumps(rows)}")

    # Q22: customer at a tenth of orders' rows, as gen_orders draws its
    # customer keys; the scalar avg is a global f32 sum (Kahan kernel),
    # NOT EXISTS an anti join against orders
    n_cust = len(orders["o_orderkey"]) // 10
    t0 = time.perf_counter()
    cust = tpch.gen_customer(n_cust, args.seed + 2)
    session.sql(tpch.CUSTOMER_DDL)
    session.insert_arrays("customer", list(cust.values()))
    log(f"customer_load_s {time.perf_counter() - t0:.3f} rows {n_cust}")
    rows = run("q22", session, tpch.Q22, args.reps,
               {"joins": 1, "masked_kahan_sum": True})
    check_rows("Q22 vs numpy", rows, q22_oracle(cust, orders), 1e-6)
    log(f"q22 {json.dumps(rows)}")
    del cust

    # scalar and string functions in a GROUP BY, over lineitem
    rows = run("functions", session, FUNCTIONS_QUERY, args.reps,
               {"joins": 0})
    check_rows("functions query vs numpy", sorted(rows, key=lambda r: r[:2]),
               functions_oracle(li), 1e-6)
    log(f"functions {json.dumps(sorted(rows, key=lambda r: r[:2]))}")

    # Q18 on its own session at SF 1: its IN subquery's result substitutes
    # a literal list (about 19% of orders: 4.6M literals at SF 16)
    n_l, n_o = ROWS_PER_SF, ORDERS_PER_SF
    li18 = tpch.gen_lineitem(n_l, args.seed)
    o18 = tpch.gen_orders(n_o, n_o // 10, args.seed + 1)
    c18 = tpch.gen_customer(n_o // 10, args.seed + 2)
    s18 = SnappySession(catalog=Catalog())
    for ddl, name, cols in ((tpch.LINEITEM_DDL, "lineitem", li18),
                            (tpch.ORDERS_DDL, "orders", o18),
                            (tpch.CUSTOMER_DDL, "customer", c18)):
        s18.sql(ddl)
        s18.insert_arrays(name, list(cols.values()))
    sub = []
    run_sub = s18._run_subquery

    def timed_subquery(plan, params):
        t0 = time.perf_counter()
        res = run_sub(plan, params)
        torch.cuda.synchronize()
        sub.append((time.perf_counter() - t0, res.num_rows))
        return res

    s18._run_subquery = timed_subquery
    q18_reps = min(args.reps, 1)
    # the subquery groups every order (1.5M groups) and the outer query
    # every passing one: past the default max_groups (65,536) the generic
    # group-key lane reroutes to the host in both packages
    saved_groups = props.max_groups
    props.max_groups = 1 << 21
    try:
        t0 = time.perf_counter()
        rows = run("q18", s18, tpch.Q18, q18_reps, {"joins": 2})
        total_s = time.perf_counter() - t0
    finally:
        props.max_groups = saved_groups
    n_in, want, cut = q18_oracle(li18, o18, c18)
    sub_s = sum(t for t, _ in sub)
    log(f"q18 sf 1 reduced (the IN subquery's result substitutes one "
        f"literal per passing order: about 4.6M at SF 16) in_list_len "
        f"{sub[0][1]} subquery_s {json.dumps([round(t, 4) for t, _ in sub])}"
        f" outer_s {(total_s - sub_s) / (1 + q18_reps):.4f} per run")
    if sub[0][1] != n_in or len(rows) != 100:
        fail(f"Q18: IN list {sub[0][1]} (numpy {n_in}), {len(rows)} rows")
    prices = [r[4] for r in rows]
    if any(a < b for a, b in zip(prices, prices[1:])) \
            or min(prices) < cut * (1 - 1e-6):
        fail("Q18 rows are not the 100 highest prices in order")
    for r in rows:
        w = want.get(r[2])
        if w is None:
            if r[4] > cut * (1 + 1e-6):
                fail(f"Q18 row {r} is not in numpy's top 100")
            continue
        check_rows("Q18 vs numpy", [r], [w], 1e-6)
    del s18, li18, o18, c18
    log(f"q18_first_rows {json.dumps(rows[:3])}")
    log("answers ok: Q4, Q22, the functions query and Q18 match numpy, "
        "on the device")
    return total


# --- phase 15: window functions over orders --------------------------------

WINDOW_DATES = ("1995-01-01", "1997-01-01")
WINDOW_QUERY = (
    "SELECT o_orderkey, "
    "row_number() OVER (PARTITION BY o_custkey ORDER BY o_orderdate, "
    "o_orderkey), "
    "rank() OVER (PARTITION BY o_custkey ORDER BY o_orderdate), "
    "dense_rank() OVER (PARTITION BY o_custkey ORDER BY o_totalprice DESC), "
    "sum(o_totalprice) OVER (PARTITION BY o_custkey ORDER BY o_orderdate), "
    "count(*) OVER (PARTITION BY o_custkey ORDER BY o_orderdate), "
    "avg(o_totalprice) OVER (PARTITION BY o_custkey ORDER BY o_orderdate), "
    "min(o_totalprice) OVER (PARTITION BY o_custkey ORDER BY o_orderdate), "
    "max(o_totalprice) OVER (PARTITION BY o_custkey ORDER BY o_orderdate), "
    "lag(o_totalprice) OVER (PARTITION BY o_custkey ORDER BY o_orderdate, "
    "o_orderkey), "
    "lead(o_totalprice) OVER (PARTITION BY o_custkey ORDER BY o_orderdate, "
    "o_orderkey) "
    f"FROM orders WHERE o_orderdate >= DATE '{WINDOW_DATES[0]}' "
    f"AND o_orderdate < DATE '{WINDOW_DATES[1]}'")


def window_oracle(orders, tpch):
    """Phase 15's columns in numpy, one row per passing order in key
    order: a lexsort by (custkey, date, key), segment and tie bounds,
    prefix sums, and running min / max through per-segment offsets.
    Prices are the float32-rounded values the card's plates hold, so
    ranks over them are exact; NaN marks a NULL lag / lead."""
    import numpy as np

    od = orders["o_orderdate"].astype(np.int64)
    m = (od >= tpch._days(WINDOW_DATES[0])) \
        & (od < tpch._days(WINDOW_DATES[1]))
    key = orders["o_orderkey"][m]
    cust = orders["o_custkey"][m]
    date = od[m]
    price = orders["o_totalprice"][m].astype(np.float32).astype(np.float64)
    n = len(key)
    pos = np.arange(n)

    def segments(new):
        sid = np.cumsum(new) - 1
        starts = np.flatnonzero(new)
        return sid, starts[sid], np.r_[starts[1:], n][sid] - 1

    order = np.lexsort((key, date, cust))
    cs, ds, ps = cust[order], date[order], price[order]
    new_seg = np.r_[True, cs[1:] != cs[:-1]]
    sid, first, _last = segments(new_seg)
    tie_new = new_seg | np.r_[True, ds[1:] != ds[:-1]]
    _tid, tfirst, tlast = segments(tie_new)
    c = np.cumsum(ps)
    run_sum = (c - (c[first] - ps[first]))[tlast]
    run_cnt = (pos - first + 1)[tlast]
    off = sid.astype(np.float64) * float(1 << 20)   # > every price
    run_min = (np.minimum.accumulate(ps - off) + off)[tlast]
    run_max = (np.maximum.accumulate(ps + off) - off)[tlast]
    lag = np.where(new_seg, np.nan, np.r_[np.nan, ps[:-1]])
    lead = np.where(np.r_[new_seg[1:], True], np.nan, np.r_[ps[1:], np.nan])
    sorted_cols = [pos - first + 1, tfirst - first + 1, None, run_sum,
                   run_cnt, run_sum / run_cnt, run_min, run_max, lag, lead]
    o2 = np.lexsort((-price, cust))
    c2, p2 = cust[o2], price[o2]
    new2 = np.r_[True, c2[1:] != c2[:-1]]
    tid2 = np.cumsum(new2 | np.r_[True, p2[1:] != p2[:-1]]) - 1
    _s, first2, _l = segments(new2)
    dense = np.empty(n, dtype=np.int64)
    dense[o2] = tid2 - tid2[first2] + 1
    by_key = np.argsort(key)
    inv = np.empty(n, dtype=np.int64)
    inv[order] = pos
    cols = [key[by_key]]
    for j, col in enumerate(sorted_cols):
        cols.append(dense[by_key] if j == 2 else col[inv][by_key])
    return cols


def check_window(res, want):
    """The session's window Result against the oracle columns: ranks and
    counts exact, running sums / averages / extremes and lag / lead
    within rel 1e-6, NULLs exactly where the oracle has NaN."""
    import numpy as np

    keys = np.asarray(res.columns[0]).astype(np.int64)
    if len(keys) != len(want[0]):
        fail(f"window query: {len(keys)} rows, numpy {len(want[0])}")
    by = np.argsort(keys)
    if not (keys[by] == want[0]).all():
        fail("window query: order keys differ from numpy's")
    exact = {1: "row_number", 2: "rank", 3: "dense_rank", 5: "count"}
    for j in range(1, 11):
        got = np.asarray(res.columns[j])[by]
        nl = res.nulls[j]
        nl = np.zeros(len(got), np.bool_) if nl is None \
            else np.asarray(nl)[by]
        w = np.asarray(want[j], dtype=np.float64)
        wn = np.isnan(w)
        if (nl != wn).any():
            fail(f"window column {j}: NULLs differ from numpy "
                 f"({int(nl.sum())} vs {int(wn.sum())})")
        g = got[~nl].astype(np.float64)
        w = w[~wn]
        if j in exact:
            if not (g == w).all():
                bad = int(np.flatnonzero(g != w)[0])
                fail(f"window {exact[j]}: {g[bad]} != numpy {w[bad]}")
        else:
            err = np.abs(g - w) / np.maximum(np.abs(w), 1e-30)
            if len(err) and err.max() > 1e-6:
                fail(f"window column {j}: max rel err {err.max():.3g}")


def window_path(session, tpch, orders, args):
    """Phase 15: WINDOW_QUERY once and --reps times warm with
    `host_fallbacks` read around the runs; its answer against numpy."""
    import torch

    from snappydata_tpu_torch.observability.metrics import global_registry

    reg = global_registry()
    fb = reg.counter("host_fallbacks")
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(1 + args.reps):
        t0 = time.perf_counter()
        res = session.sql(WINDOW_QUERY)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    if reg.counter("host_fallbacks") != fb:
        fail("the window query left the device")
    t0 = time.perf_counter()
    want = window_oracle(orders, tpch)
    oracle_s = time.perf_counter() - t0
    check_window(res, want)
    warm = sorted(times[1:])[len(times[1:]) // 2] if args.reps else times[0]
    log(f"window rows {res.num_rows} first_s {times[0]:.4f} warm_s "
        f"{warm:.4f} rows_per_s {res.num_rows / warm:.0f} "
        f"peak_device_bytes {peak} resident_before_bytes {resident} "
        f"oracle_s {oracle_s:.3f}")
    if args.profile:
        log("profile window " + json.dumps(profile_run(
            lambda: session.sql(WINDOW_QUERY))))
    log("answers ok: the window query matches numpy, on the device")


# --- phase 16: mutations, MVCC pins, HTAP, row tables ----------------------

MUTATION_UPDATE = ("UPDATE lineitem SET l_discount = l_discount + 0.01 "
                   "WHERE l_shipdate >= DATE '1998-01-01' "
                   "AND l_discount < 0.10")
MUTATION_DELETE = "DELETE FROM lineitem WHERE l_quantity >= 49"
MUTATION_INSERT_ROWS = 131_072
HTAP_QUERY = "SELECT count(*), sum(l_extendedprice) FROM lineitem"
HTAP_BATCHES = 8


class PinnedReader:
    """A thread that holds one `mvcc.pinned_scope` over lineitem: it reads
    Q1 and Q6 when it pins (binding that version's plates), waits, reads
    them again under the same pin, and releases when told."""

    def __init__(self, session, tpch):
        import threading

        self.session, self.tpch = session, tpch
        self.pinned = threading.Event()
        self.go = threading.Event()
        self.done = threading.Event()
        self.out = {}
        self.error = None
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()
        if not self.pinned.wait(600) or self.error:
            fail(f"pinned reader: {self.error}")

    def _run(self):
        import torch

        from snappydata_tpu_torch.storage import mvcc

        try:
            with mvcc.pinned_scope(self.session.catalog, ["lineitem"]):
                self.out["before"] = run_queries(self.session, self.tpch)
                self.pinned.set()
                self.go.wait()
                torch.cuda.reset_peak_memory_stats()
                self.out["after"] = run_queries(self.session, self.tpch)
                self.out["peak"] = torch.cuda.max_memory_allocated()
        except Exception as e:  # noqa: BLE001 - reported by the caller
            self.error = f"{type(e).__name__}: {e}"
        finally:
            self.pinned.set()
            self.done.set()

    def read_again(self):
        self.go.set()
        if not self.done.wait(900) or self.error:
            fail(f"pinned reader: {self.error}")
        return self.out


def mutated_lineitem(li, code, extra, tpch):
    """The generated arrays after phase 16's UPDATE, DELETE and insert, as
    the card's plates hold them: l_discount float32 (the UPDATE's
    arithmetic and compare run at the plate width), rows with l_quantity
    >= 49 gone, the inserted rows appended.  Only the columns the later
    oracles read (VIEW_COLUMNS), in `view_arrays` form: `code` is the
    generated rows' `flag_status_code`, so no object column is copied or
    compared again."""
    import numpy as np

    disc = li["l_discount"].astype(np.float32)
    hit = (li["l_shipdate"] >= tpch._days("1998-01-01")) \
        & (disc < np.float32(0.10))
    disc = np.where(hit, disc + np.float32(0.01), disc)
    keep = li["l_quantity"] < 49
    more = view_arrays({k: extra[k] for k in VIEW_COLUMNS})
    out = {}
    for k in more:
        col = disc if k == "l_discount" else code if k == "g" else li[k]
        tail = more[k].astype(np.float32) if k == "l_discount" else more[k]
        out[k] = np.concatenate([col[keep], tail])
    return out, int(hit.sum()), int((~keep).sum())


def q10_oracle(li, orders, cust, tpch):
    """TPC-H Q10 in float64 numpy: per-order date filter and customer,
    then `np.bincount` of the returned lines' revenue per customer."""
    import numpy as np

    od = orders["o_orderdate"]
    ok = (od >= tpch._days("1993-10-01")) & (od < tpch._days("1994-01-01"))
    row = li["l_orderkey"] - 1
    has = row < len(od)   # inserted lines may name orders that are absent
    row = np.where(has, row, 0)
    m = has & ok[row] & (li["g"] // 2 == 2)   # l_returnflag 'R' 
    ck = orders["o_custkey"][row[m]]
    rev = (li["l_extendedprice"] * (1 - li["l_discount"].astype(
        np.float64)))[m]
    tot = np.bincount(ck, weights=rev, minlength=len(cust["c_custkey"]) + 1)
    top = np.argsort(-tot, kind="stable")[:20]
    names = tpch.gen_nation()["n_name"]
    bal = cust["c_acctbal"].astype(np.float32).astype(np.float64)
    return [(int(c), cust["c_name"][c - 1], float(tot[c]), float(bal[c - 1]),
             names[cust["c_nationkey"][c - 1]]) for c in top if tot[c] > 0]


def mutation_path(session, tpch, li, code, orders, cust, first, args):
    """Phase 16 (a) - (h); returns the two kernels' launches over (e) and
    lineitem's columns that phase 21 reads (`view_arrays` form), as the
    phase leaves them.  `code` is `li`'s `flag_status_code`."""
    import threading

    import numpy as np
    import torch

    from snappydata_tpu_torch import SnappySession, config
    from snappydata_tpu_torch.engine import executor
    from snappydata_tpu_torch.observability.metrics import global_registry
    from snappydata_tpu_torch.ops import group_reduce as gr
    from snappydata_tpu_torch.ops import kahan_reduce as kr

    props = config.global_properties()
    props.pallas_reduce = True
    props.pallas_group_reduce = True
    reg = global_registry()

    # (a) a reader pins lineitem's current version
    reader = PinnedReader(session, tpch)
    for q in ("q1", "q6"):
        check_rows(f"pinned {q} before the mutations vs phase 4",
                   reader.out["before"][q][0], first[q][0], 1e-9)

    # (b) - (d) the mutations
    t0 = time.perf_counter()
    n_upd = int(session.sql(MUTATION_UPDATE).rows()[0][0])
    upd_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    n_del = int(session.sql(MUTATION_DELETE).rows()[0][0])
    del_s = time.perf_counter() - t0
    extra = tpch.gen_lineitem(MUTATION_INSERT_ROWS, args.seed + 3)
    t0 = time.perf_counter()
    session.insert_arrays("lineitem", list(extra.values()))
    ins_s = time.perf_counter() - t0
    mut, want_upd, want_del = mutated_lineitem(li, code, extra, tpch)
    log(f"mutation update rows {n_upd} s {upd_s:.3f} rows_per_s "
        f"{n_upd / upd_s:.0f}; delete rows {n_del} s {del_s:.3f} "
        f"rows_per_s {n_del / del_s:.0f}; insert rows "
        f"{MUTATION_INSERT_ROWS} s {ins_s:.3f}")
    if (n_upd, n_del) != (want_upd, want_del):
        fail(f"UPDATE / DELETE touched {n_upd} / {n_del} rows, numpy "
             f"{want_upd} / {want_del}")

    # (e) Q1 and Q6 over the mutated table, counters at 0
    cf0 = reg.counter("compressed_fallback_deltas")
    out = {}
    launches = {"grouped_reduce": 0, "masked_kahan_sum": 0}
    for name, sql in (("q1", tpch.Q1), ("q6", tpch.Q6)):
        rows, f_s, w_s, moved, lc, calls, peak, resident = \
            timed_query(session, sql, args.reps)
        out[name] = rows
        log(f"mutated_{name} first_s {f_s:.4f} warm_s {w_s:.4f} counters "
            f"{json.dumps(moved)} launches {json.dumps(lc)} "
            f"peak_device_bytes {peak} resident_before_bytes {resident}")
        if moved["host_fallbacks"]:
            fail(f"mutated {name} left the device")
        kname = "grouped_reduce" if name == "q1" else "masked_kahan_sum"
        if lc[kname] < 1 + args.reps:
            fail(f"{kname} launched {lc[kname]} times over mutated "
                 f"{name}'s {1 + args.reps} runs")
        for k in launches:
            launches[k] += lc[k]
        phase = grouped_phase if kname == "grouped_reduce" else kahan_phase
        log(f"kernel {kname} on mutated {name} "
            f"{json.dumps(phase(calls[kname], args.reps))}")
        del calls
        if args.profile:
            log(f"profile mutated_{name} " + json.dumps(profile_run(
                lambda sql=sql: session.sql(sql).rows())))
    cf = reg.counter("compressed_fallback_deltas") - cf0
    log(f"compressed_fallback_deltas moved {cf}")
    if cf < 1:
        fail("the updated l_discount kept its encoded form")
    want = oracle(mut, tpch)
    for q in ("q1", "q6"):
        check_rows(f"mutated {q} vs numpy", out[q], want[q])
    log(f"mutated_q1 {json.dumps(out['q1'])}")
    log(f"mutated_q6 {json.dumps(out['q6'])}")

    # (f) the pinned reader still sees phase 4's table
    pinned = reader.read_again()
    for q in ("q1", "q6"):
        check_rows(f"pinned {q} after the mutations vs phase 4",
                   pinned["after"][q][0], first[q][0], 1e-9)
    log(f"pinned_reader q1_s {pinned['after']['q1'][1]:.4f} q6_s "
        f"{pinned['after']['q6'][1]:.4f} peak_device_bytes_both_versions "
        f"{pinned['peak']} allocated_bytes {torch.cuda.memory_allocated()}")
    log("answers ok: mutated Q1 / Q6 match numpy; the pinned reader's "
        "match phase 4")

    # (g) HTAP: one thread scans while a second session inserts
    price = mut["l_extendedprice"].astype(np.float32).astype(np.float64)
    states = [(len(price), float(price.sum()))]
    batches = [tpch.gen_lineitem(MUTATION_INSERT_ROWS, args.seed + 10 + i)
               for i in range(HTAP_BATCHES)]
    for b in batches:
        p = b["l_extendedprice"].astype(np.float32).astype(np.float64)
        states.append((states[-1][0] + len(p), states[-1][1] + p.sum()))
    writer = SnappySession(catalog=session.catalog)
    scans, ingest_s = [], []
    stop = threading.Event()

    def ingest():
        for b in batches:
            t0 = time.perf_counter()
            writer.insert_arrays("lineitem", list(b.values()))
            ingest_s.append(time.perf_counter() - t0)
            time.sleep(0.5)   # paced, so the scans interleave the inserts
        stop.set()

    fb = reg.counter("host_fallbacks")
    th = threading.Thread(target=ingest, daemon=True)
    th.start()
    while not stop.is_set() or len(scans) < 8:
        t0 = time.perf_counter()
        cnt, sm = session.sql(HTAP_QUERY).rows()[0]
        scans.append((time.perf_counter() - t0, int(cnt), float(sm)))
    th.join()
    serial = []
    for _ in range(8):
        t0 = time.perf_counter()
        session.sql(HTAP_QUERY).rows()
        serial.append(time.perf_counter() - t0)
    mismatches = 0
    for _t, cnt, sm in scans:
        hit = [s for c, s in states if c == cnt]
        if not hit or abs(sm - hit[0]) > 1e-6 * abs(hit[0]):
            mismatches += 1
    if reg.counter("host_fallbacks") != fb:
        fail("an HTAP scan left the device")

    def pct(ts, q):
        ts = sorted(ts)
        return ts[min(len(ts) - 1, int(len(ts) * q))]

    conc = [t for t, _c, _s in scans]
    log(f"htap scans {len(scans)} states_seen "
        f"{len({c for _t, c, _s in scans})} mismatches {mismatches} "
        f"concurrent_p50_s {pct(conc, 0.5):.4f} p99_s {pct(conc, 0.99):.4f}"
        f" serialized_p50_s {pct(serial, 0.5):.4f} p99_s "
        f"{pct(serial, 0.99):.4f} ingest_rows_per_s "
        f"{HTAP_BATCHES * MUTATION_INSERT_ROWS / sum(ingest_s):.0f}")
    if mismatches:
        fail(f"{mismatches} HTAP scans saw no single epoch")
    htap_batches = batches
    del price

    # (h) row tables: nation and region, Q10, PUT INTO and get
    session.sql(tpch.NATION_DDL)
    session.sql(tpch.REGION_DDL)
    session.insert_arrays("nation", list(tpch.gen_nation().values()))
    session.insert_arrays("region", list(tpch.gen_region().values()))
    saved_groups = props.max_groups
    props.max_groups = 1 << 22   # Q10 groups every returning customer
    try:
        rows, f_s, w_s, moved, _lc, _calls, peak, _res = \
            timed_query(session, tpch.Q10, args.reps)
    finally:
        props.max_groups = saved_groups
    log(f"q10 first_s {f_s:.4f} warm_s {w_s:.4f} counters "
        f"{json.dumps(moved)} peak_device_bytes {peak}")
    if args.profile:
        props.max_groups = 1 << 22
        try:
            log("profile q10 " + json.dumps(profile_run(
                lambda: session.sql(tpch.Q10).rows())))
        finally:
            props.max_groups = saved_groups
    if moved["host_fallbacks"] or moved["join_host_fallbacks"] \
            or moved["join_device_joins"] < 1 + args.reps:
        fail(f"Q10 left the device: {moved}")
    # lineitem as the phase leaves it (the HTAP batches too), for Q10's
    # oracle and phase 21's
    more = [view_arrays({k: b[k] for k in VIEW_COLUMNS})
            for b in htap_batches]
    post = {k: np.concatenate([mut[k]] + [
        b[k].astype(np.float32) if k == "l_discount" else b[k]
        for b in more]) for k in mut}
    check_rows("Q10 vs numpy", rows, q10_oracle(post, orders, cust, tpch))
    log(f"q10 {json.dumps(rows[:3], default=str)}")

    # PUT INTO the row table nation (one upsert, one insert), get(), and
    # PUT INTO a keyed column table
    session.sql("PUT INTO nation VALUES (7, 'GERMANIA', 3), "
                "(25, 'ATLANTIS', 1)")
    got = [tuple(session.get("nation", (k,)) or ()) for k in (7, 25, 3)]
    want_get = [(7, "GERMANIA", 3), (25, "ATLANTIS", 1),
                (3, "CANADA", 1)]
    if [tuple(x if isinstance(x, str) else int(x) for x in g)
            for g in got] != want_get:
        fail(f"nation after PUT INTO: get() {got}, expected {want_get}")
    cnt = session.sql("SELECT count(*), sum(n_regionkey) FROM nation"
                      ).rows()[0]
    if tuple(cnt) != (26, sum(tpch.gen_nation()["n_regionkey"]) + 1):
        fail(f"nation after PUT INTO: {cnt}")
    session.sql("CREATE TABLE kv (k BIGINT, v DOUBLE) USING column "
                "OPTIONS (key_columns 'k')")
    session.insert_arrays("kv", [np.arange(100_000, dtype=np.int64),
                                 np.ones(100_000)])
    session.sql("PUT INTO kv VALUES (5, 100.0), (100000, 7.0)")
    kv = tuple(session.sql("SELECT count(*), sum(v), max(v) FROM kv"
                           ).rows()[0])
    if kv != (100_001, 100_106.0, 100.0):
        fail(f"keyed column table after PUT INTO: {kv}")
    log(f"put_into nation get {json.dumps(got, default=str)} kv "
        f"{json.dumps(kv, default=str)}")
    log("answers ok: HTAP scans saw single epochs; Q10 over the row table "
        "nation matches numpy; PUT INTO and get() upsert on the key")
    return launches, post


# --------------------------------------------------------------------------
# phase 21: views, materialized views and SQL functions, on the main
# session as phase 16 leaves it
# --------------------------------------------------------------------------

VIEW_COLUMNS = ("l_returnflag", "l_linestatus", "l_quantity",
                "l_extendedprice", "l_discount", "l_tax", "l_shipdate",
                "l_suppkey", "l_orderkey")
Q1_MV_SELECT = ("SELECT l_returnflag, l_linestatus, sum(l_quantity), "
                "sum(l_extendedprice), "
                "sum(l_extendedprice * (1 - l_discount)), count(*) "
                "FROM lineitem "
                "WHERE l_shipdate <= DATE '1998-12-01' - INTERVAL '90' DAY "
                "GROUP BY l_returnflag, l_linestatus")
Q1_MV = "CREATE MATERIALIZED VIEW q1_mv AS " + Q1_MV_SELECT
Q1_MV_READ = "SELECT * FROM q1_mv ORDER BY l_returnflag, l_linestatus"
REV_FUNCTION = "CREATE FUNCTION rev AS 'lambda p, d: p * d' RETURNS DOUBLE"
CAPPED_FUNCTION = "CREATE FUNCTION capped AS 'lambda x: jnp.clip(x, 10, 40)'"
CAPPED_Q1 = ("SELECT l_returnflag, l_linestatus, "
             "sum(capped(l_quantity)), count(*) FROM lineitem "
             "WHERE l_shipdate <= DATE '1998-12-01' - INTERVAL '90' DAY "
             "GROUP BY l_returnflag, l_linestatus "
             "ORDER BY l_returnflag, l_linestatus")
FOLD_ROWS = (1, 1024)         # 131,072 cut to keep the run's time
VIEW_DELETE_KEYS = 5          # DELETE the rows of orders 1 .. 5
VIEW_DELETE = f"DELETE FROM lineitem WHERE l_orderkey <= {VIEW_DELETE_KEYS}"
VIEW_UPDATE_KEYS = 2000       # UPDATE l_discount of orders 1 .. 2000
DURABLE_VIEW_ROWS = 1_000_000   # phase 21 (f), cut to keep the run's time
CHEAP_VIEW = ("CREATE VIEW cheap AS SELECT l_returnflag, l_extendedprice "
              "FROM lineitem WHERE l_discount < 0.025")
CHEAP_READ = ("SELECT l_returnflag, sum(l_extendedprice), count(*) "
              "FROM cheap GROUP BY l_returnflag ORDER BY l_returnflag")


def rev_q6(tpch):
    q = tpch.Q6.replace("sum(l_extendedprice * l_discount)",
                        "sum(rev(l_extendedprice, l_discount))")
    if q == tpch.Q6:
        fail("Q6's revenue expression moved: rev() was not substituted")
    return q


def view_arrays(cols):
    """The numeric columns phase 21's oracles read, with Q1's group as
    one small code `g` = 2 * flag (A 0, N 1, R 2) + status (F 0, O 1):
    the string compares over ~98M object cells are done once."""
    out = {k: v for k, v in cols.items()
           if k not in ("l_returnflag", "l_linestatus")}
    out["g"] = flag_status_code(cols["l_returnflag"], cols["l_linestatus"])
    return out


def _per_group(arrs, tpch, weights):
    import numpy as np

    # rows past Q1's cutoff count in a seventh, dropped bin (as oracle())
    g = np.where(arrs["l_shipdate"] <= tpch._days("1998-12-01") - 90,
                 arrs["g"], 6)
    cnt = np.bincount(g, minlength=7)[:6]
    sums = [np.bincount(g, weights=w, minlength=7)[:6] for w in weights]
    return [("ANR"[c // 2], "FO"[c % 2]) + tuple(float(x[c]) for x in sums)
            + (int(cnt[c]),) for c in range(6) if cnt[c]]


def mv_oracle(arrs, tpch):
    """q1_mv's rows in float64 numpy: keys, three sums, count."""
    price = arrs["l_extendedprice"]
    return _per_group(arrs, tpch, [
        arrs["l_quantity"], price,
        price * (1 - arrs["l_discount"].astype("float64"))])


def capped_oracle(arrs, tpch):
    import numpy as np

    return _per_group(arrs, tpch, [np.clip(arrs["l_quantity"], 10, 40)])


def q6_oracle(arrs, tpch):
    ship, disc = arrs["l_shipdate"], arrs["l_discount"]
    m6 = (ship >= tpch._days("1994-01-01")) \
        & (ship < tpch._days("1995-01-01")) \
        & (disc >= 0.05) & (disc <= 0.07) & (arrs["l_quantity"] < 24)
    return [(float((arrs["l_extendedprice"][m6] * disc[m6]).sum()),)]


def cheap_oracle(arrs):
    m = arrs["l_discount"] < 0.025
    out = []
    for i, f in enumerate("ANR"):
        mf = m & (arrs["g"] // 2 == i)
        if mf.any():
            out.append((f, float(arrs["l_extendedprice"][mf].sum()),
                        int(mf.sum())))
    return out


def q15_check(rows, arrs, supp):
    """Q15's rows against float64 revenue per supplier computed from the
    plates' float32 values: every row is a supplier within rel 1e-6 of
    the top revenue, with its name and its revenue within rel 1e-6."""
    import numpy as np

    price = arrs["l_extendedprice"].astype(np.float32)
    disc = arrs["l_discount"].astype(np.float32)
    rev = (price * (np.float32(1) - disc)).astype(np.float64)
    per = np.bincount(arrs["l_suppkey"], weights=rev)
    top = per.max()
    if not rows:
        fail("Q15 returned no rows")
    for k, name, total in rows:
        if not (abs(per[k] - top) <= 1e-6 * top
                and abs(total - per[k]) <= 1e-6 * per[k]
                and name == supp["s_name"][k - 1]):
            fail(f"Q15 row {(k, name, total)}: numpy top {top} at "
                 f"{int(per.argmax())}, supplier {k} has {per[k]}")


def _append(arrs, extra, f32_discount=True):
    """`arrs` (`view_arrays` form) with the generated rows `extra`
    appended; l_discount as float32 where the rows join a table whose
    l_discount the phase updated at the plate width (phase 16's
    convention), as generated otherwise."""
    import numpy as np

    more = view_arrays({k: extra[k] for k in VIEW_COLUMNS})
    return {k: np.concatenate([arrs[k], more[k].astype(np.float32)
                               if k == "l_discount" and f32_discount
                               else more[k]])
            for k in arrs}


class FoldTimer:
    """Sums the seconds every `MaterializedView.fold_delta` call takes
    while installed."""

    def __init__(self):
        from snappydata_tpu_torch.views.matview import MaterializedView

        self.cls = MaterializedView
        self.real = MaterializedView.fold_delta
        self.s = 0.0
        timer = self

        def timed(mv, *a, **kw):
            import torch

            t0 = time.perf_counter()
            try:
                return timer.real(mv, *a, **kw)
            finally:
                torch.cuda.synchronize()
                timer.s += time.perf_counter() - t0

        MaterializedView.fold_delta = timed

    def close(self):
        self.cls.fold_delta = self.real


def views_path(session, tpch, li, post, first, args):
    """Phase 21 (a) - (f); returns the two kernels' launches and the
    columns phase 22's oracles read (`view_arrays` form) as the phase
    leaves lineitem.  `li` is the
    generated lineitem, `post` its columns as phase 16 left the table,
    `first` phase 4's Q1 / Q6 (rows, seconds)."""
    import gc

    import numpy as np
    import torch

    from snappydata_tpu_torch import config, resource
    from snappydata_tpu_torch.engine import executor
    from snappydata_tpu_torch.observability.metrics import global_registry
    from snappydata_tpu_torch.ops import group_reduce as gr
    from snappydata_tpu_torch.ops import kahan_reduce as kr
    from snappydata_tpu_torch.views import matview as mvmod

    props = config.global_properties()
    props.pallas_reduce = True
    props.pallas_group_reduce = True
    reg = global_registry()
    arrs = post
    total = {"grouped_reduce": 0, "masked_kahan_sum": 0}

    def drain():
        # timed_query sets both counters to 0: fold them into the phase's
        # total before and after each call
        _launch_sum(total, {"grouped_reduce": gr.grouped_reduce.launches,
                            "masked_kahan_sum": kr.masked_kahan_sum.launches})
        gr.grouped_reduce.launches = 0
        kr.masked_kahan_sum.launches = 0

    drain()
    total = dict.fromkeys(total, 0)

    # (a) TPC-H Q15 through CREATE VIEW revenue_v
    # supplier at TPC-H's 10,000 rows per SF, and at least the generated
    # lineitem's l_suppkey range (1 .. 9,999) below SF 1
    supp = tpch.gen_supplier(max(10_000, int(args.sf * 10_000)),
                             args.seed + 3)
    session.sql(tpch.SUPPLIER_DDL)
    session.insert_arrays("supplier", list(supp.values()))
    session.sql(tpch.Q15_VIEW)
    drain()
    rows, f_s, w_s, moved, _lc, _calls, peak, _res = \
        timed_query(session, tpch.Q15, args.reps)
    drain()
    log(f"q15 first_s {f_s:.4f} warm_s {w_s:.4f} rows {len(rows)} "
        f"counters {json.dumps(moved)} peak_device_bytes {peak}")
    # the reference's routing (tests/test_torch_views.py): the supplier
    # join over the aggregated view and the subquery's max run on the host
    if (moved["host_fallbacks"], moved["join_device_joins"]) != \
            (2 * (1 + args.reps), 0):
        fail(f"Q15 routing {moved} is not the reference's (2 host "
             "fallbacks a run, no device join)")
    q15_check(rows, arrs, supp)
    log(f"q15 {json.dumps(rows, default=str)}")
    if args.profile:
        log("profile q15 " + json.dumps(profile_run(
            lambda: session.sql(tpch.Q15).rows())))

    # (b) SQL functions on the device
    session.sql(REV_FUNCTION)
    session.sql(CAPPED_FUNCTION)
    drain()
    rows, f_s, w_s, moved, lc, q6_calls, _peak, _res = \
        timed_query(session, rev_q6(tpch), args.reps)
    drain()
    log(f"rev_q6 first_s {f_s:.4f} warm_s {w_s:.4f} (phase 4 q6 first_s "
        f"{first['q6'][1]:.4f}) counters {json.dumps(moved)} launches "
        f"{json.dumps(lc)}")
    if moved["host_fallbacks"]:
        fail("Q6 through rev() left the device")
    if lc["masked_kahan_sum"] != 1 + args.reps:
        fail(f"masked_kahan_sum launched {lc['masked_kahan_sum']} times "
             f"over rev() Q6's {1 + args.reps} runs")
    check_rows("Q6 through rev() vs numpy", rows, q6_oracle(arrs, tpch))
    rows, f_s, w_s, moved, lc, _calls, _peak, _res = \
        timed_query(session, CAPPED_Q1, args.reps)
    drain()
    log(f"capped_q1 first_s {f_s:.4f} warm_s {w_s:.4f} (phase 4 q1 "
        f"first_s {first['q1'][1]:.4f}) counters {json.dumps(moved)} "
        f"launches {json.dumps(lc)}")
    if moved["host_fallbacks"] or lc["grouped_reduce"] < 1 + args.reps:
        fail(f"Q1 through capped() left the device or skipped the grouped "
             f"kernel: {moved} {lc}")
    check_rows("Q1 through capped() vs numpy", rows,
               capped_oracle(arrs, tpch))

    # (c) a materialized Q1 view: one full refresh over the table
    broker = resource.global_broker()
    torch.cuda.synchronize()
    alloc0 = torch.cuda.memory_allocated()
    dev0 = broker.ledger()["device"]
    rec = Recorder(executor.grouped_reduce, keep=1)
    executor.grouped_reduce = rec
    try:
        t0 = time.perf_counter()
        session.sql(Q1_MV)
        torch.cuda.synchronize()
        create_s = time.perf_counter() - t0
    finally:
        executor.grouped_reduce = rec.fn
    mv_calls = rec.calls
    mv = mvmod.matviews(session.catalog)["q1_mv"]
    alloc1 = torch.cuda.memory_allocated()
    dev1 = broker.ledger()["device"]
    ledger = broker.ledger()["matview_state_bytes"]
    # the refresh's grouped-kernel inputs this phase keeps for the kernel
    # check below: each distinct storage once
    held = {}
    for a in mv_calls[0] if mv_calls else ():
        for x in (a if isinstance(a, (list, tuple)) else (a,)):
            for t in (x if isinstance(x, (list, tuple)) else (x,)):
                if isinstance(t, torch.Tensor):
                    st = t.untyped_storage()
                    held[st.data_ptr()] = st.nbytes()
    reads = []
    for _ in range(1 + args.reps):
        t0 = time.perf_counter()
        rows = session.sql(Q1_MV_READ).rows()
        reads.append(time.perf_counter() - t0)
    log(f"q1_mv create_s {create_s:.4f} read_first_s {reads[0]:.4f} "
        f"read_warm_s {sorted(reads[1:])[len(reads[1:]) // 2]:.4f} "
        f"matview_state_bytes {ledger} state_nbytes {mv.state_nbytes()} "
        f"groups {mv.snapshot()['groups']} capacity "
        f"{mv.snapshot()['capacity']} memory_allocated {alloc0} -> {alloc1}")
    log(f"q1_mv create device_bytes_by_table before {json.dumps(dev0)} "
        f"after {json.dumps(dev1)} recorded_refresh_input_bytes "
        f"{sum(held.values())}")
    del held
    if ledger != mvmod.matview_state_nbytes() or mv.state_nbytes() <= 0:
        fail(f"ledger matview_state_bytes {ledger} != the views' "
             f"state_nbytes {mvmod.matview_state_nbytes()}")
    check_rows("q1_mv vs numpy", rows, mv_oracle(arrs, tpch))

    # (d) folds of 1 and 1,024 inserted rows
    for i, n in enumerate(FOLD_ROWS):
        extra = tpch.gen_lineitem(n, args.seed + 20 + i)
        f0 = reg.counter("view_delta_folds")
        r0 = reg.counter("view_full_refreshes")
        timer = FoldTimer()
        try:
            t0 = time.perf_counter()
            session.insert_arrays("lineitem", list(extra.values()))
            torch.cuda.synchronize()
            ins_s = time.perf_counter() - t0
        finally:
            timer.close()
        arrs = _append(arrs, extra)
        t0 = time.perf_counter()
        rows = session.sql(Q1_MV_READ).rows()
        read_s = time.perf_counter() - t0
        log(f"q1_mv fold rows {n} insert_s {ins_s:.4f} fold_s "
            f"{timer.s:.4f} fold_share {timer.s / ins_s:.3f} read_s "
            f"{read_s:.4f}")
        if reg.counter("view_delta_folds") - f0 != 1 or \
                reg.counter("view_full_refreshes") != r0:
            fail(f"the {n}-row insert did not fold exactly once")
        check_rows(f"q1_mv after a {n}-row insert vs numpy", rows,
                   mv_oracle(arrs, tpch))
    if args.profile:
        extra = tpch.gen_lineitem(1024, args.seed + 29)
        log("profile q1_mv_fold " + json.dumps(profile_run(
            lambda: session.insert_arrays("lineitem",
                                          list(extra.values())))))
        arrs = _append(arrs, extra)
        log("profile q1_mv_read " + json.dumps(profile_run(
            lambda: session.sql(Q1_MV_READ).rows())))

    # (e) a DELETE subtracts; an UPDATE marks the view stale
    s0 = reg.counter("view_subtract_folds")
    t0 = time.perf_counter()
    n_del = int(session.sql(VIEW_DELETE).rows()[0][0])
    del_s = time.perf_counter() - t0
    keep = ~(arrs["l_orderkey"] <= VIEW_DELETE_KEYS)
    arrs = {k: v[keep] for k, v in arrs.items()}
    rows = session.sql(Q1_MV_READ).rows()
    log(f"q1_mv delete rows {n_del} s {del_s:.4f} stale {mv.stale}")
    if n_del != int((~keep).sum()) or mv.stale \
            or reg.counter("view_subtract_folds") - s0 != 1:
        fail(f"DELETE of {n_del} rows (numpy {int((~keep).sum())}) did not "
             "subtract from the fresh view")
    check_rows("q1_mv after the DELETE vs numpy", rows,
               mv_oracle(arrs, tpch))
    session.sql(f"UPDATE lineitem SET l_discount = l_discount + 0.01 "
                f"WHERE l_orderkey <= {VIEW_UPDATE_KEYS}")
    hit = arrs["l_orderkey"] <= VIEW_UPDATE_KEYS
    # the store adds in float64 to the plate's float32 value, then rounds
    # to the plate width: 0.04 + 0.01 lands on float32(0.05)
    arrs["l_discount"] = np.where(
        hit, (arrs["l_discount"].astype(np.float64) + 0.01)
        .astype(np.float32), arrs["l_discount"]).astype(np.float32)
    if not mv.stale:
        fail("an UPDATE of the base left the view fresh")
    r0 = reg.counter("view_full_refreshes")
    t0 = time.perf_counter()
    rows = session.sql(Q1_MV_READ).rows()
    refresh_s = time.perf_counter() - t0
    log(f"q1_mv update rows {int(hit.sum())} stale read (full refresh) s "
        f"{refresh_s:.4f}")
    if reg.counter("view_full_refreshes") - r0 != 1:
        fail("the stale view's read did not refresh in full")
    check_rows("q1_mv after the UPDATE vs numpy", rows,
               mv_oracle(arrs, tpch))
    # the drop hands back the view's bytes: its state, its backing table
    # and its scratch tables leave the device ledger
    session.sql("DROP MATERIALIZED VIEW q1_mv")
    del mv
    gc.collect()
    torch.cuda.synchronize()
    dev2 = broker.ledger()["device"]
    alloc2 = torch.cuda.memory_allocated()
    state2 = broker.ledger()["matview_state_bytes"]
    log(f"q1_mv drop device_bytes_by_table {json.dumps(dev2)} "
        f"matview_state_bytes {state2} memory_allocated {alloc2}")
    left = {k: v for k, v in dev2.items()
            if k in ("q1_mv", "__mv_delta", "__mv_partials") and v}
    if left or state2:
        fail(f"DROP MATERIALIZED VIEW left device bytes behind: {left}, "
             f"matview_state_bytes {state2}")
    drain()
    log("answers ok: Q15, rev() Q6, capped() Q1 and q1_mv through its "
        "folds, subtraction and refresh match numpy")

    # the kernels on the inputs (c)'s refresh and (b)'s Q6 handed them
    log(f"kernel grouped_reduce on q1_mv refresh "
        f"{json.dumps(grouped_phase(mv_calls, args.reps))}")
    log(f"kernel masked_kahan_sum on rev() q6 "
        f"{json.dumps(kahan_phase(q6_calls['masked_kahan_sum'], args.reps))}")
    del mv_calls, q6_calls
    gc.collect()
    torch.cuda.synchronize()
    log(f"memory_allocated once the recorded kernel inputs are released "
        f"{torch.cuda.memory_allocated()}")

    # (f) durable views, on a durable session of its own
    _launch_sum(total, durable_views(tpch, {k: v[:DURABLE_VIEW_ROWS]
                                            for k, v in li.items()}, args))
    return total, arrs


def durable_views(tpch, gen, args):
    """Phase 21 (f): q1_mv, rev() and a plain view on a durable lineitem
    (`gen`: the first DURABLE_VIEW_ROWS generated rows), a checkpoint, a
    two-statement WAL tail, a crash-shape reopen; returns the two
    kernels' launches."""
    import shutil
    import tempfile

    from snappydata_tpu_torch import SnappySession
    from snappydata_tpu_torch.catalog import Catalog
    from snappydata_tpu_torch.observability.metrics import global_registry
    from snappydata_tpu_torch.ops import group_reduce as gr
    from snappydata_tpu_torch.ops import kahan_reduce as kr
    from snappydata_tpu_torch.views import matview as mvmod

    reg = global_registry()
    d = tempfile.mkdtemp(prefix="chip_smoke_views_")
    gr.grouped_reduce.launches = 0
    kr.masked_kahan_sum.launches = 0
    try:
        li = view_arrays({k: gen[k] for k in VIEW_COLUMNS})
        names = list(gen.keys())
        s1 = SnappySession(catalog=Catalog(), data_dir=d, recover=False)
        s1.sql(tpch.LINEITEM_DDL)
        for lo in range(0, DURABLE_VIEW_ROWS, DURABLE_STMT_ROWS):
            s1.insert_arrays("lineitem", [gen[k][lo:lo + DURABLE_STMT_ROWS]
                                          for k in names])
        s1.sql(Q1_MV)
        s1.sql(REV_FUNCTION)
        s1.sql(CHEAP_VIEW)
        t0 = time.perf_counter()
        s1.checkpoint()
        ck_s = time.perf_counter() - t0
        tail = [tpch.gen_lineitem(n, args.seed + 40 + i)
                for i, n in enumerate((1024, 4096))]
        for extra in tail:
            s1.insert_arrays("lineitem", list(extra.values()))
            li = _append(li, extra, f32_discount=False)
        rp0 = reg.counter("view_replay_folds")
        rf0 = reg.counter("view_full_refreshes")
        t0 = time.perf_counter()
        s2 = SnappySession(data_dir=d)   # crash shape: s1 stays open
        rec_s = time.perf_counter() - t0
        mv = mvmod.matviews(s2.catalog)["q1_mv"]
        replays = reg.counter("view_replay_folds") - rp0
        log(f"durable_views rows {DURABLE_VIEW_ROWS} checkpoint_s {ck_s:.4f}"
            f" recovery_s {rec_s:.4f} replay_folds {replays} stale "
            f"{mv.stale}")
        if mv.stale or replays != len(tail):
            fail(f"the recovered q1_mv is stale ({mv.stale}) or folded "
                 f"{replays} WAL records, not the {len(tail)} of the tail")
        check_rows("recovered q1_mv vs numpy", s2.sql(Q1_MV_READ).rows(),
                   mv_oracle(li, tpch))
        if reg.counter("view_full_refreshes") != rf0:
            fail("the recovered q1_mv re-aggregated in full")
        check_rows("recovered rev() Q6 vs numpy",
                   s2.sql(rev_q6(tpch)).rows(), q6_oracle(li, tpch))
        check_rows("recovered plain view vs numpy", s2.sql(CHEAP_READ).rows(),
                   cheap_oracle(li))
        s1.disk_store.close()
        s2.disk_store.close()
        log("answers ok: the durable view state reloaded, only the WAL tail "
            "folded; q1_mv, rev() Q6 and the plain view match numpy")
        return {"grouped_reduce": gr.grouped_reduce.launches,
                "masked_kahan_sum": kr.masked_kahan_sum.launches}
    finally:
        shutil.rmtree(d, ignore_errors=True)


# --------------------------------------------------------------------------
# phase 22: prepared statements, the micro-batcher, the group-index cache,
# secondary indexes and row-level policies, on the main session as phase
# 21 leaves lineitem
# --------------------------------------------------------------------------

SERVING_Q6 = ("SELECT sum(l_extendedprice * l_discount) AS revenue "
              "FROM lineitem WHERE l_shipdate >= ? AND l_shipdate < ? "
              "AND l_discount BETWEEN ? AND ? AND l_quantity < ?")
SERVING_Q1 = ("SELECT l_returnflag, l_linestatus, sum(l_quantity), "
              "sum(l_extendedprice), "
              "sum(l_extendedprice * (1 - l_discount)), count(*) "
              "FROM lineitem WHERE l_shipdate <= ? "
              "GROUP BY l_returnflag, l_linestatus "
              "ORDER BY l_returnflag, l_linestatus")
SERVING_CLIENTS = (1, 4, 16)
SERVING_CALLS = 8             # executes per client thread
SERVING_BANDS = ((0.02, 0.04), (0.03, 0.05), (0.05, 0.07), (0.06, 0.08))
INDEX_ROWS = 150_000          # SF 1 customer rows in a row table
INDEX_LOOKUPS = 500
TRACE_PAIRS = 5               # phase 24 (b): interleaved pairs per --reps
POLICY = "CREATE POLICY li_tax ON lineitem USING l_tax < 0.05"
SERVING_COUNTERS = ("serving_prepared_hits", "serving_prepared_misses",
                    "serving_reprepares", "serving_passthrough",
                    "serving_batched_dispatches", "serving_batch_requests",
                    "serving_straight_through", "serving_batch_fallbacks",
                    "serving_vmap_compiles", "serving_bulk_transfers",
                    "plan_cache_misses", "host_fallbacks", "point_lookups",
                    "gidx_cache_hits", "gidx_cache_misses")


def q6_bind(tpch, year, band, qty=24):
    return (tpch._days(f"{year}-01-01"), tpch._days(f"{year + 1}-01-01"),
            band[0], band[1], qty)


def q6_literal(tpch, year, band, qty=24):
    return ("SELECT sum(l_extendedprice * l_discount) AS revenue "
            f"FROM lineitem WHERE l_shipdate >= DATE '{year}-01-01' "
            f"AND l_shipdate < DATE '{year + 1}-01-01' "
            f"AND l_discount BETWEEN {band[0]} AND {band[1]} "
            f"AND l_quantity < {qty}")


def q6_bound_oracle(arrs, bind, extra=None):
    """Prepared Q6's answer in float64 numpy over `arrs` (phase 21's
    `view_arrays` form); `extra` an additional row mask (a policy)."""
    lo, hi, dlo, dhi, qty = bind
    ship, disc = arrs["l_shipdate"], arrs["l_discount"]
    m = (ship >= lo) & (ship < hi) & (disc >= dlo) & (disc <= dhi) \
        & (arrs["l_quantity"] < qty)
    if extra is not None:
        m &= extra
    return [(float((arrs["l_extendedprice"][m] * disc[m]).sum()),)]


def q1_bound_oracle(arrs, ship_max):
    """Prepared Q1's rows (keys, three sums, count) in float64 numpy."""
    import numpy as np

    m = arrs["l_shipdate"] <= ship_max
    g = arrs["g"][m]
    price = arrs["l_extendedprice"][m]
    ws = [arrs["l_quantity"][m], price,
          price * (1 - arrs["l_discount"][m].astype(np.float64))]
    cnt = np.bincount(g, minlength=6)
    sums = [np.bincount(g, weights=w, minlength=6) for w in ws]
    return [("ANR"[c // 2], "FO"[c % 2]) + tuple(float(x[c]) for x in sums)
            + (int(cnt[c]),) for c in range(6) if cnt[c]]


def _counters(reg):
    return {k: reg.counter(k) for k in SERVING_COUNTERS}


def _moved(reg, before):
    return {k: reg.counter(k) - before[k] for k in SERVING_COUNTERS}


def _kernel_counts():
    from snappydata_tpu_torch.ops import group_reduce as gr
    from snappydata_tpu_torch.ops import kahan_reduce as kr

    return {"grouped_reduce": gr.grouped_reduce.launches,
            "masked_kahan_sum": kr.masked_kahan_sum.launches}


def _reset_kernel_counts():
    from snappydata_tpu_torch.ops import group_reduce as gr
    from snappydata_tpu_torch.ops import kahan_reduce as kr

    gr.grouped_reduce.launches = 0
    kr.masked_kahan_sum.launches = 0


def serve_clients(handle, binds, n_clients):
    """`n_clients` threads, client c executing binds[c] one after the
    other through `handle.execute`: (answers {(c, i): rows}, per-request
    seconds, wall seconds)."""
    import threading

    answers, lat, errors = {}, [], []
    barrier = threading.Barrier(n_clients)

    def client(c):
        try:
            barrier.wait(timeout=120)
            for i, b in enumerate(binds[c]):
                t0 = time.perf_counter()
                answers[(c, i)] = handle.execute(b).rows()
                lat.append(time.perf_counter() - t0)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(f"{type(e).__name__}: {e}")

    ts = [threading.Thread(target=client, args=(c,), daemon=True)
          for c in range(n_clients)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in ts):
        fail(f"a serving client of {n_clients} hung")
    if errors:
        fail(f"serving clients raised: {errors[:3]}")
    return answers, lat, wall


def batcher_run(session, handle, label, binds_of, solo, kernel, reg):
    """(b): 1, 4 and 16 clients x SERVING_CALLS executes each; every
    answer equal to its bind's solo answer, `kernel` launched once per
    request, no batch fallback."""
    import numpy as np
    import torch

    out = {}
    for n in SERVING_CLIENTS:
        binds = [[binds_of[(c * SERVING_CALLS + i) % len(binds_of)]
                  for i in range(SERVING_CALLS)] for c in range(n)]
        before = _counters(reg)
        torch.cuda.synchronize()
        _reset_kernel_counts()
        answers, lat, wall = serve_clients(handle, binds, n)
        torch.cuda.synchronize()
        lc = _kernel_counts()
        moved = _moved(reg, before)
        total = n * SERVING_CALLS
        for (c, i), rows in answers.items():
            if rows != solo[binds[c][i]]:
                fail(f"{label} with {n} clients: bind {binds[c][i]} gave "
                     f"{rows}, solo {solo[binds[c][i]]}")
        if len(answers) != total:
            fail(f"{label} with {n} clients: {len(answers)} answers of "
                 f"{total}")
        if moved["serving_batch_fallbacks"]:
            fail(f"{label} with {n} clients fell back "
                 f"{moved['serving_batch_fallbacks']} times")
        if lc[kernel] != total:
            fail(f"{label} with {n} clients: {kernel} launched "
                 f"{lc[kernel]} times for {total} requests")
        lat_ms = np.array(lat) * 1e3
        disp = moved["serving_batched_dispatches"]
        occ = moved["serving_batch_requests"] / disp if disp else None
        out[n] = {"requests": total, "wall_s": round(wall, 4),
                  "requests_per_s": round(total / wall, 1),
                  "p50_ms": round(float(np.percentile(lat_ms, 50)), 3),
                  "p99_ms": round(float(np.percentile(lat_ms, 99)), 3),
                  "batched_dispatches": disp, "occupancy": occ,
                  "straight_through": moved["serving_straight_through"],
                  "bulk_transfers": moved["serving_bulk_transfers"],
                  "launches": lc}
        log(f"serving {label} clients {n} {json.dumps(out[n])}")
    return out


def serving_path(session, tpch, arrs, args):
    """Phase 22 (a) - (e) on the main session; returns (the two
    kernels' launches, arrs after (c)'s one-row insert)."""
    import numpy as np
    import torch

    from snappydata_tpu_torch import config, resource
    from snappydata_tpu_torch.engine import executor
    from snappydata_tpu_torch.observability.metrics import global_registry

    props = config.global_properties()
    props.pallas_reduce = True
    props.pallas_group_reduce = True
    props.serving_batch_max = 16
    props.serving_batch_wait_us = 200.0
    reg = global_registry()
    total = {"grouped_reduce": 0, "masked_kahan_sum": 0}
    t_phase = time.perf_counter()
    # the counters still hold the earlier phases' last launches (and the
    # plain-version comparisons'): this phase counts from 0
    _reset_kernel_counts()

    # (a) SQL PREPARE / EXECUTE of Q6 with three bind vectors
    vectors = [(1994, (0.05, 0.07), 24), (1995, (0.02, 0.04), 30),
               (1997, (0.06, 0.08), 12)]
    lits = {}
    for year, band, qty in vectors:
        lits[(year, band, qty)] = session.sql(
            q6_literal(tpch, year, band, qty)).rows()
    _launch_sum(total, _kernel_counts())
    t0 = time.perf_counter()
    session.sql("PREPARE q6p AS " + SERVING_Q6)
    prep_s = time.perf_counter() - t0
    before = _counters(reg)
    _reset_kernel_counts()
    for year, band, qty in vectors:
        bind = q6_bind(tpch, year, band, qty)
        times = []
        for _ in range(1 + args.reps):
            t0 = time.perf_counter()
            rows = session.sql("EXECUTE q6p (%d, %d, %r, %r, %d)"
                               % bind).rows()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        lit = lits[(year, band, qty)]
        check_rows(f"EXECUTE q6p {bind} vs the literal query", rows, lit)
        check_rows(f"EXECUTE q6p {bind} vs numpy", rows,
                   q6_bound_oracle(arrs, bind))
        log(f"serving prepared_q6 bind {list(bind)} first_s "
            f"{times[0]:.4f} warm_s "
            f"{sorted(times[1:])[len(times[1:]) // 2]:.4f} revenue "
            f"{rows[0][0]!r} literal_equal {rows == lit}")
    lc = _kernel_counts()
    moved = _moved(reg, before)
    execs = len(vectors) * (1 + args.reps)
    log(f"serving prepared_q6 prepare_s {prep_s:.4f} counters "
        f"{json.dumps(moved)} launches {json.dumps(lc)}")
    if moved["plan_cache_misses"] or moved["host_fallbacks"]:
        fail(f"prepared Q6: plan-cache misses or host fallbacks {moved}")
    if moved["serving_prepared_hits"] < execs - 1:
        fail(f"prepared Q6: {moved['serving_prepared_hits']} registry hits "
             f"over {execs} executes")
    if lc["masked_kahan_sum"] != execs:
        fail(f"masked_kahan_sum launched {lc['masked_kahan_sum']} times "
             f"over {execs} executes")
    _launch_sum(total, lc)

    # (b) the micro-batcher: Q6 (Kahan kernel), then Q1 (grouped kernel)
    q6h = session.prepare(SERVING_Q6)
    q1h = session.prepare(SERVING_Q1)
    q6_binds = [q6_bind(tpch, y, b) for y in range(1993, 1998)
                for b in SERVING_BANDS]
    q1_binds = [(tpch._days("1992-06-01") + 120 * i,) for i in range(20)]
    batch_out = {}
    for label, h, binds, kernel in (
            ("q6", q6h, q6_binds, "masked_kahan_sum"),
            ("q1", q1h, q1_binds, "grouped_reduce")):
        entry = h._entry
        _reset_kernel_counts()
        t0 = time.perf_counter()
        with config.device_scope(session.device):
            solo = {b: session.executor.execute(
                entry.tokenized, entry.lit_params + b).rows()
                for b in binds}
        torch.cuda.synchronize()
        _launch_sum(total, _kernel_counts())
        log(f"serving {label} solo answers {len(binds)} binds s "
            f"{time.perf_counter() - t0:.3f}")
        # the solo answers against numpy: the first and the last bind
        for b in binds[:1] + binds[-1:]:
            want = q6_bound_oracle(arrs, b) if label == "q6" \
                else q1_bound_oracle(arrs, b[0])
            check_rows(f"solo {label} {b} vs numpy", solo[b], want)
        batch_out[label] = batcher_run(session, h, label, binds, solo,
                                       kernel, reg)
        for r in batch_out[label].values():
            _launch_sum(total, r["launches"])
        if batch_out[label][16]["batched_dispatches"] < 1:
            fail(f"{label}: 16 clients never shared a fused dispatch")

    # (c) the group-index cache: a prepared Q1, one bind, three executes
    executor.clear_gidx_cache()
    bind = (tpch._days("1998-09-02"),)
    broker = resource.global_broker()
    torch.cuda.synchronize()
    alloc0 = torch.cuda.memory_allocated()
    before = _counters(reg)
    _reset_kernel_counts()
    secs = []
    for _ in range(3):
        t0 = time.perf_counter()
        rows = q1h.execute(bind).rows()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    lc = _kernel_counts()
    moved = _moved(reg, before)
    alloc1 = torch.cuda.memory_allocated()
    ledger = broker.ledger()["gidx_cache_bytes"]
    log(f"gidx_cache miss_s {secs[0]:.4f} hit_s {secs[1]:.4f} "
        f"{secs[2]:.4f} hits {moved['gidx_cache_hits']} misses "
        f"{moved['gidx_cache_misses']} entry_bytes "
        f"{executor.gidx_cache_nbytes()} ledger {ledger} memory_allocated "
        f"{alloc0} -> {alloc1} launches {json.dumps(lc)}")
    if (moved["gidx_cache_misses"], moved["gidx_cache_hits"]) != (1, 2):
        fail(f"gidx cache: {moved['gidx_cache_misses']} misses and "
             f"{moved['gidx_cache_hits']} hits, expected 1 and 2")
    if ledger != executor.gidx_cache_nbytes() or ledger <= 0:
        fail(f"ledger gidx_cache_bytes {ledger} != the cache's "
             f"{executor.gidx_cache_nbytes()}")
    if lc["grouped_reduce"] != 3:
        fail(f"grouped_reduce launched {lc['grouped_reduce']} times over "
             "the 3 cached executes")
    check_rows("cached Q1 vs numpy", rows, q1_bound_oracle(arrs, bind[0]))
    extra = tpch.gen_lineitem(1, args.seed + 40)
    session.insert_arrays("lineitem", list(extra.values()))
    arrs = _append(arrs, extra)
    before = _counters(reg)
    t0 = time.perf_counter()
    rows = q1h.execute(bind).rows()
    torch.cuda.synchronize()
    ins_s = time.perf_counter() - t0
    _launch_sum(total, _kernel_counts())     # (c)'s four executes
    moved = _moved(reg, before)
    log(f"gidx_cache after a 1-row insert s {ins_s:.4f} misses "
        f"{moved['gidx_cache_misses']} hits {moved['gidx_cache_hits']}")
    if moved["gidx_cache_misses"] != 1 or moved["gidx_cache_hits"]:
        fail(f"the 1-row insert did not rotate the gidx entry: {moved}")
    check_rows("Q1 after the 1-row insert vs numpy", rows,
               q1_bound_oracle(arrs, bind[0]))
    executor.clear_gidx_cache()
    torch.cuda.synchronize()
    log(f"gidx_cache cleared bytes {executor.gidx_cache_nbytes()} "
        f"memory_allocated {torch.cuda.memory_allocated()}")

    # (d) a secondary index on a row table of SF 1 customer rows
    cust = tpch.gen_customer(INDEX_ROWS, args.seed + 50)
    session.sql("CREATE TABLE cust_row (c_custkey BIGINT PRIMARY KEY, "
                "c_name STRING, c_nationkey INT, c_acctbal DOUBLE, "
                "c_mktsegment STRING) USING row")
    t0 = time.perf_counter()
    session.insert_arrays("cust_row", list(cust.values()))
    load_s = time.perf_counter() - t0
    session.sql("CREATE INDEX cust_by_name ON cust_row (c_name)")
    rng = np.random.default_rng(args.seed + 51)
    keys = rng.integers(1, INDEX_ROWS + 1, INDEX_LOOKUPS)
    ph = session.prepare("SELECT c_custkey, c_acctbal FROM cust_row "
                         "WHERE c_name = ?")
    before = _counters(reg)
    _reset_kernel_counts()
    rates = {}
    for lane in ("sql", "prepared"):
        t0 = time.perf_counter()
        for k in keys:
            name = f"Customer#{int(k):09d}"
            rows = session.sql(
                "SELECT c_custkey, c_acctbal FROM cust_row WHERE "
                f"c_name = '{name}'").rows() if lane == "sql" \
                else ph.execute((name,)).rows()
            if rows != [(int(k), float(cust["c_acctbal"][k - 1]))]:
                fail(f"index lookup ({lane}) of {name}: {rows}")
        rates[lane] = len(keys) / (time.perf_counter() - t0)
    moved = _moved(reg, before)
    lc = _kernel_counts()
    log(f"index load_s {load_s:.3f} rows {INDEX_ROWS} lookups_per_s "
        f"{json.dumps({k: round(v, 1) for k, v in rates.items()})} "
        f"point_lookups {moved['point_lookups']} launches {json.dumps(lc)}")
    if moved["point_lookups"] != 2 * len(keys) or any(lc.values()):
        fail(f"index lookups: {moved['point_lookups']} point lookups for "
             f"{2 * len(keys)}, launches {lc}")
    # the index table and its prepared lookup stay for phase 24
    index = {"handle": ph, "keys": keys,
             "acctbal": cust["c_acctbal"]}
    del cust

    # (e) a row-level policy under the held Q6 handle
    bind = q6_bind(tpch, 1994, (0.05, 0.07))
    before = _counters(reg)
    session.sql(POLICY)
    t0 = time.perf_counter()
    rows = q6h.execute(bind).rows()
    torch.cuda.synchronize()
    pol_s = time.perf_counter() - t0
    moved = _moved(reg, before)
    taxed = arrs["l_tax"] < 0.05
    check_rows("Q6 under the policy vs numpy", rows,
               q6_bound_oracle(arrs, bind, taxed))
    if moved["serving_reprepares"] != 1:
        fail(f"CREATE POLICY re-prepared the held handle "
             f"{moved['serving_reprepares']} times")
    session.sql("DROP POLICY li_tax")
    rows2 = q6h.execute(bind).rows()
    check_rows("Q6 after DROP POLICY vs numpy", rows2,
               q6_bound_oracle(arrs, bind))
    log(f"policy q6 s {pol_s:.4f} revenue {rows[0][0]!r} (unfiltered "
        f"{rows2[0][0]!r}) reprepares {moved['serving_reprepares']}")
    _launch_sum(total, _kernel_counts())
    props.serving_batch_wait_us = 200.0
    log(f"serving_path_s {time.perf_counter() - t_phase:.3f}")
    return total, arrs, batch_out, index


def _explain_field(rows, needle, key):
    line = next((r[0] for r in rows if needle in r[0]), None)
    if line is None:
        fail(f"EXPLAIN ANALYZE printed no line with {needle!r}: {rows}")
    for tok in line.replace("]", " ").replace("[", " ").split():
        if tok.startswith(key + "="):
            return tok.split("=", 1)[1]
    fail(f"EXPLAIN ANALYZE line {line!r} has no {key}=")


def _median(xs):
    return sorted(xs)[len(xs) // 2]


def _prometheus_names(text):
    """(sample names, TYPE names) of a Prometheus text exposition; fails
    on a line that does not parse."""
    import re

    name_re = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
    samples, typed = [], []
    for ln in text.splitlines():
        if not ln:
            continue
        if ln.startswith("# TYPE "):
            parts = ln.split()
            if len(parts) != 4 or not name_re.match(parts[2]):
                fail(f"prometheus: bad TYPE line {ln!r}")
            typed.append(parts[2])
            continue
        if ln.startswith("#"):
            continue
        head, _, value = ln.rpartition(" ")
        name = head.split("{", 1)[0]
        if not name_re.match(name):
            fail(f"prometheus: bad sample name in {ln!r}")
        try:
            float(value)
        except ValueError:
            fail(f"prometheus: bad sample value in {ln!r}")
        samples.append(name)
    return samples, typed


def observability_path(session, tpch, index, args):
    """Phase 24 on the main session as phase 22 leaves it: EXPLAIN /
    EXPLAIN ANALYZE of Q1 and Q6, the tracing layer's cost, grants on the
    card, the stats service and the query log.  Returns the two kernels'
    launches."""
    import numpy as np
    import torch

    from snappydata_tpu_torch import config, resource
    from snappydata_tpu_torch.observability import stats_service, tracing
    from snappydata_tpu_torch.observability.metrics import global_registry
    from snappydata_tpu_torch.storage.device import \
        device_cache_bytes_by_table

    props = config.global_properties()
    props.pallas_reduce = True
    props.pallas_group_reduce = True
    reg = global_registry()
    total = {"grouped_reduce": 0, "masked_kahan_sum": 0}
    t_phase = time.perf_counter()
    traced0 = props.tracing_enabled
    props.tracing_enabled = True
    plain = {"q1": session.sql(tpch.Q1).rows(),
             "q6": session.sql(tpch.Q6).rows()}
    torch.cuda.synchronize()

    # (a) EXPLAIN launches nothing; EXPLAIN ANALYZE runs the query once
    # through its kernel and names it
    for q, kernel, lane in (("q1", "grouped_reduce", "grouped"),
                            ("q6", "masked_kahan_sum", "kahan")):
        sql = getattr(tpch, q.upper())
        _reset_kernel_counts()
        text = session.sql("EXPLAIN " + sql).rows()
        if any(_kernel_counts().values()):
            fail(f"plain EXPLAIN of {q} launched {_kernel_counts()}")
        c0 = reg.counters_snapshot()
        t0 = time.perf_counter()
        rows = session.sql("EXPLAIN ANALYZE " + sql).rows()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        lc = _kernel_counts()
        _launch_sum(total, lc)
        c1 = reg.counters_snapshot()
        strategies = _explain_field(rows, "HashAggregate",
                                    "strategy").split(",")
        rows_out = int(_explain_field(rows, "trace_id=", "rows_out"))
        tid = _explain_field(rows, "trace_id=", "trace_id")
        phases_line = next(r[0] for r in rows if r[0].startswith("phases:"))
        phases = {k: float(v[:-2]) for k, v in (
            tok.split("=", 1) for tok in phases_line.split()[1:])}
        log(f"explain {q} plan {json.dumps([r[0] for r in text])}")
        log(f"explain_analyze {q} wall_s {wall:.4f} rows_out {rows_out} "
            f"strategies {strategies} trace_id {tid} phases_ms "
            f"{json.dumps(phases)} phase_sum_ms "
            f"{sum(phases.values()):.3f} launches {json.dumps(lc)} "
            f"host_fallbacks "
            f"{c1.get('host_fallbacks', 0) - c0.get('host_fallbacks', 0)}")
        log(f"explain_analyze {q} footer "
            f"{json.dumps([r[0] for r in rows if '=' in r[0]][-4:])}")
        if rows_out != len(plain[q]):
            fail(f"EXPLAIN ANALYZE {q}: rows_out {rows_out}, the plain "
                 f"query {len(plain[q])}")
        if lane not in strategies:
            fail(f"EXPLAIN ANALYZE {q} names {strategies}, not {lane}")
        if lc[kernel] != 1:
            fail(f"EXPLAIN ANALYZE {q} launched {kernel} {lc[kernel]} "
                 "times, expected once")
        if not tracing.ring().get(tid):
            fail(f"EXPLAIN ANALYZE {q}: trace {tid} is not in the ring")
        if sum(phases.values()) > wall * 1e3:
            fail(f"EXPLAIN ANALYZE {q}: phases sum to "
                 f"{sum(phases.values()):.3f} ms over {wall * 1e3:.3f} ms")

    # (b) the tracing layer's cost: warm Q1 / Q6 and the prepared point
    # lookups with tracing on and off, interleaved, TRACE_PAIRS x --reps
    # pairs (a warm Q6's run-to-run spread is several times the span
    # layer's cost); logged beside the reference's 3% bound (bench.py
    # trace_tol), never a failure
    secs = {(q, on): [] for q in ("q1", "q6", "lookup") for on in (1, 0)}
    ph, keys = index["handle"], index["keys"]
    names = [f"Customer#{int(k):09d}" for k in keys]
    pairs = TRACE_PAIRS * args.reps
    _reset_kernel_counts()
    for _ in range(pairs):
        for on in (1, 0):
            props.tracing_enabled = bool(on)
            for q in ("q1", "q6"):
                t0 = time.perf_counter()
                session.sql(getattr(tpch, q.upper())).rows()
                torch.cuda.synchronize()
                secs[(q, on)].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            for name in names:
                ph.execute((name,)).rows()
            secs[("lookup", on)].append(time.perf_counter() - t0)
    props.tracing_enabled = True
    _launch_sum(total, _kernel_counts())
    med = {k: _median(v) for k, v in secs.items()}
    over = {q: (med[(q, 1)] / med[(q, 0)] - 1.0) * 100.0
            for q in ("q1", "q6", "lookup")}
    geo = (np.sqrt(med[("q1", 1)] * med[("q6", 1)])
           / np.sqrt(med[("q1", 0)] * med[("q6", 0)]) - 1.0) * 100.0
    quart = {f"{q}_{'on' if on else 'off'}": [
        round(float(np.percentile(v, p)) * 1e3, 3) for p in (25, 75)]
        for (q, on), v in secs.items()}
    log(f"tracing_cost pairs {pairs} q1_s on/off "
        f"{med[('q1', 1)]:.5f}/{med[('q1', 0)]:.5f} q6_s on/off "
        f"{med[('q6', 1)]:.5f}/{med[('q6', 0)]:.5f} lookups_per_s on/off "
        f"{len(names) / med[('lookup', 1)]:.1f}/"
        f"{len(names) / med[('lookup', 0)]:.1f} overhead_pct "
        f"{json.dumps({k: round(v, 2) for k, v in over.items()})} "
        f"q1_q6_geomean_pct {geo:.2f} (reference bound 3%) "
        f"quartiles_ms {json.dumps(quart)}")

    # (c) grants: a principal without them is refused before admission;
    # granted, its Q6 equals the admin's bit for bit; a REVOKE refuses
    # the next execute of a held prepared handle
    broker = resource.global_broker()
    analyst = session.for_user("analyst")
    if analyst.device != session.device:
        fail(f"for_user moved the session from {session.device} to "
             f"{analyst.device}")
    led0 = broker.ledger()
    adm0 = reg.counter("governor_admitted")
    _reset_kernel_counts()
    try:
        analyst.sql(tpch.Q6)
        fail("analyst's Q6 ran without a grant")
    except PermissionError as e:
        denied = str(e)
    lc = _kernel_counts()
    led1 = broker.ledger()
    same = all(led0[k] == led1[k] for k in ("host", "device", "queries",
                                            "inflight_bytes"))
    log(f"grants denied {denied!r} launches {json.dumps(lc)} "
        f"admitted {reg.counter('governor_admitted') - adm0} "
        f"ledger_unchanged {same}")
    if any(lc.values()) or not same \
            or reg.counter("governor_admitted") != adm0:
        fail(f"the denied Q6 launched {lc}, was admitted or moved the "
             "ledger")
    session.sql("GRANT SELECT ON lineitem TO analyst")
    admin_q6 = session.sql(tpch.Q6).rows()
    _reset_kernel_counts()
    t0 = time.perf_counter()
    granted = analyst.sql(tpch.Q6).rows()
    torch.cuda.synchronize()
    g_s = time.perf_counter() - t0
    lc = _kernel_counts()
    _launch_sum(total, lc)
    log(f"grants granted_q6 {granted[0][0]!r} admin_q6 {admin_q6[0][0]!r} "
        f"equal {granted == admin_q6} s {g_s:.4f} launches "
        f"{json.dumps(lc)}")
    if granted != admin_q6 or lc["masked_kahan_sum"] != 1:
        fail(f"granted Q6 {granted} vs admin {admin_q6}, launches {lc}")
    bind = q6_bind(tpch, 1994, (0.05, 0.07))
    want = session.prepare(SERVING_Q6).execute(bind).rows()
    held = analyst.prepare(SERVING_Q6)
    _reset_kernel_counts()
    got = held.execute(bind).rows()
    _launch_sum(total, _kernel_counts())
    if got != want:
        fail(f"analyst's prepared Q6 {got} vs admin's {want}")
    session.sql("REVOKE SELECT ON lineitem FROM analyst")
    try:
        held.execute(bind)
        fail("the held handle executed after REVOKE")
    except PermissionError as e:
        log(f"grants prepared_execute {got[0][0]!r} equal True; after "
            f"REVOKE {e!r}")

    # (d) the stats service, the Prometheus exposition, the query log
    t0 = time.perf_counter()
    stats = stats_service.TableStatsService(session.catalog).collect_once()
    mix = stats_service.encoding_mix(session.catalog)
    dev = device_cache_bytes_by_table(
        [(i.name, i.data) for i in session.catalog.list_tables()])
    ledger = broker.ledger()["device"]
    stats_s = time.perf_counter() - t0
    li_rows = session.catalog.describe("lineitem").data.snapshot() \
        .total_rows()
    log(f"stats collect_s {stats_s:.3f} tables {len(stats)} lineitem rows "
        f"{stats['lineitem']['row_count']} batches "
        f"{stats['lineitem']['batches']} device_bytes "
        f"{json.dumps({t: m['device_resident_bytes'] for t, m in mix.items()})}")
    if stats["lineitem"]["row_count"] != li_rows:
        fail(f"stats lineitem rows {stats['lineitem']['row_count']} vs "
             f"{li_rows}")
    for t, m in mix.items():
        if m["device_resident_bytes"] != dev.get(t, 0) \
                or dev.get(t, 0) != ledger.get(t, 0):
            fail(f"device bytes of {t}: stats {m['device_resident_bytes']}"
                 f", device cache {dev.get(t, 0)}, ledger "
                 f"{ledger.get(t, 0)}")
    if not mix["lineitem"]["device_resident_bytes"]:
        fail("the stats service sees no device bytes under lineitem")
    samples, typed = _prometheus_names(reg.to_prometheus())
    if len(typed) != len(set(typed)):
        fail("prometheus: a TYPE name appears twice")
    log(f"prometheus samples {len(samples)} families {len(typed)}")
    log_rows = session.recent_queries()
    mine = [q for q in log_rows if q["ts"] >= time.time() - (
        time.perf_counter() - t_phase) - 1.0]
    users = sorted({q["user"] for q in mine})
    log(f"query_log entries {len(mine)} users {users} last "
        f"{json.dumps(mine[-1])}")
    if "analyst" not in users or "admin" not in users \
            or any(q["ms"] < 0 for q in mine) \
            or not any(q["user"] == "analyst" and q["ms"] > 0
                       and q["sql"] == tpch.Q6 for q in mine):
        fail(f"the query log lacks the phase's queries: {mine[-5:]}")
    session.sql("DROP TABLE cust_row")
    props.tracing_enabled = traced0
    log(f"observability_path_s {time.perf_counter() - t_phase:.3f}")
    return total


def serving_profiles(session, tpch):
    """--profile rows of phase 22: one fused 16-request Q6 dispatch (the
    relations bound once, 16 Kahan launches, one host copy) and one
    group-index cache hit of the prepared Q1 (phase B alone)."""
    from snappydata_tpu_torch import config
    from snappydata_tpu_torch.engine import executor

    h6 = session.prepare(SERVING_Q6)
    e6 = h6._entry
    binds = [e6.lit_params + q6_bind(tpch, y, b) for y in range(1993, 1997)
             for b in SERVING_BANDS]
    h1 = session.prepare(SERVING_Q1)
    bind = (tpch._days("1998-09-02"),)
    with config.device_scope(session.device):
        compiled = e6.compiled_for(session)
        compiled.execute_batched(binds, session.device, bucket=16)
        log("profile fused_q6_16 " + json.dumps(profile_run(
            lambda: compiled.execute_batched(binds, session.device,
                                             bucket=16))))
        h1.execute(bind)          # the miss fills the entry
        log("profile gidx_hit_q1 " + json.dumps(profile_run(
            lambda: h1.execute(bind).rows())))
    executor.clear_gidx_cache()


# --------------------------------------------------------------------------
# phase 23: AQP — a sample table, WITH ERROR and TopK (reduced)
# --------------------------------------------------------------------------

AQP_ROWS = 2_097_152
AQP_SAMPLE = ("CREATE SAMPLE TABLE lineitem_s ON lineitem_aqp OPTIONS "
              "(qcs 'l_returnflag, l_linestatus', reservoir_size '10000', "
              "seed '7')")
AQP_Q1 = ("SELECT l_returnflag, l_linestatus, sum(l_quantity) AS sq, "
          "absolute_error(sq), lower_bound(sq), upper_bound(sq), "
          "avg(l_extendedprice) AS ap, lower_bound(ap), upper_bound(ap), "
          "count(*) AS c FROM lineitem_aqp "
          "GROUP BY l_returnflag, l_linestatus "
          "ORDER BY l_returnflag, l_linestatus "
          "WITH ERROR 0.1 CONFIDENCE 0.95")
AQP_AVG = ("SELECT avg(l_extendedprice) AS ap, absolute_error(ap), "
           "lower_bound(ap), upper_bound(ap) FROM lineitem_aqp "
           "WITH ERROR 0.1 CONFIDENCE 0.95")


def aqp_path(tpch, args):
    """Phase 23 on a session of its own; returns the two kernels'
    launches."""
    import numpy as np
    import torch

    from snappydata_tpu_torch import SnappySession, config
    from snappydata_tpu_torch.catalog import Catalog
    from snappydata_tpu_torch.observability.metrics import global_registry

    props = config.global_properties()
    props.pallas_reduce = True
    props.pallas_group_reduce = True
    reg = global_registry()
    total = {"grouped_reduce": 0, "masked_kahan_sum": 0}
    t_phase = time.perf_counter()
    _reset_kernel_counts()
    s = SnappySession(catalog=Catalog())
    s.sql(tpch.LINEITEM_DDL.replace("lineitem", "lineitem_aqp", 1))
    li = tpch.gen_lineitem(AQP_ROWS, 7)
    s.insert_arrays("lineitem_aqp", list(li.values()))
    t0 = time.perf_counter()
    s.sql(AQP_SAMPLE)
    build_s = time.perf_counter() - t0
    n_sample = s.sql("SELECT count(*) FROM lineitem_s").rows()[0][0]
    log(f"aqp sample build_s {build_s:.3f} base_rows {AQP_ROWS} "
        f"sample_rows {n_sample}")
    # exact answers
    flag, status = li["l_returnflag"], li["l_linestatus"]
    exact = {}
    for f in "ANR":
        for st in "FO":
            m = (flag == f) & (status == st)
            if m.any():
                exact[(f, st)] = (float(li["l_quantity"][m].sum()),
                                  float(li["l_extendedprice"][m].mean()),
                                  int(m.sum()))
    fb0 = reg.counter("host_fallbacks")
    for label, run in (("q1_with_error", lambda: s.sql(AQP_Q1).rows()),
                       ("avg_with_error", lambda: s.sql(AQP_AVG).rows()),
                       ("approx_avg", lambda: s.approx_sql(
                           "SELECT avg(l_extendedprice) FROM lineitem_aqp"
                       ).rows())):
        _reset_kernel_counts()
        times = []
        for _ in range(1 + args.reps):
            t0 = time.perf_counter()
            rows = run()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        lc = _kernel_counts()
        _launch_sum(total, lc)
        log(f"aqp {label} first_s {times[0]:.4f} warm_s "
            f"{sorted(times[1:])[len(times[1:]) // 2]:.4f} launches "
            f"{json.dumps(lc)}")
        if label == "q1_with_error":
            if lc["grouped_reduce"] < 1 + args.reps:
                fail(f"WITH ERROR GROUP BY skipped the grouped kernel: {lc}")
            if len(rows) != len(exact):
                fail(f"WITH ERROR Q1: {len(rows)} groups of {len(exact)}")
            for r in rows:
                f, st, sq, ae, lb, ub, ap, alb, aub, c = r
                xs, xa, xc = exact[(f, st)]
                inside = lb <= xs <= ub and alb <= xa <= aub
                log(f"aqp group {f}{st} sum_qty {sq!r} +- {ae!r} "
                    f"[{lb!r}, {ub!r}] exact {xs!r} avg_price {ap!r} "
                    f"[{alb!r}, {aub!r}] exact {xa!r} count {c} exact {xc} "
                    f"inside {inside}")
                # the groups ARE the strata: counts are known exactly; an
                # estimate five half-widths off is a wrong estimator, not
                # sampling noise
                if c != xc or abs(sq - xs) > 5 * max(ae, 1e-9) \
                        or not np.isfinite(sq):
                    fail(f"WITH ERROR Q1 group {f}{st}: {r} vs exact "
                         f"{exact[(f, st)]}")
        elif label == "avg_with_error":
            ap, ae, lb, ub = rows[0]
            xa = float(li["l_extendedprice"].mean())
            log(f"aqp avg {ap!r} +- {ae!r} [{lb!r}, {ub!r}] exact {xa!r} "
                f"inside {lb <= xa <= ub}")
            if abs(ap - xa) > 5 * ae or lc["grouped_reduce"] < 1:
                fail(f"global avg WITH ERROR {rows} vs exact {xa}: {lc}")
        else:
            xa = float(li["l_extendedprice"].mean())
            log(f"aqp approx_sql avg {rows[0][0]!r} exact {xa!r}")
            if lc["masked_kahan_sum"] < 1 + args.reps \
                    or abs(rows[0][0] - xa) > 0.01 * xa:
                fail(f"approx_sql avg {rows} vs exact {xa}: {lc}")
    if reg.counter("host_fallbacks") != fb0:
        fail("an AQP query left the device")
    t0 = time.perf_counter()
    s.create_topk("top_supp", "lineitem_aqp", "l_suppkey", k=10)
    topk_s = time.perf_counter() - t0
    top = s.query_topk("top_supp", 5).rows()
    truth = np.bincount(li["l_suppkey"])
    log(f"aqp topk build_s {topk_s:.3f} top {json.dumps(top)} true counts "
        f"{[int(truth[int(k)]) for k, _ in top]} true max "
        f"{int(truth.max())}")
    if len(top) != 5 or any(c < truth[int(k)] for k, c in top):
        fail(f"TopK undercounted: {top}")
    del s, li
    log(f"aqp_path_s {time.perf_counter() - t_phase:.3f}")
    return total


# --------------------------------------------------------------------------
# phase 18: nested orders (ARRAY / MAP / STRUCT plates)
# --------------------------------------------------------------------------

NESTED_ORDERS = 1_000_000     # SF 2/3: the cells are Python objects
NESTED_LINES = 4_000_000
NESTED_COLS = ("o_orderkey", "o_orderdate", "info", "modes", "prices",
               "qty_by_mode")


def nested_oracle(orders, li):
    """N1 / N2 in float64 numpy from the generated arrays: per order its
    line count, whether a line ships by MAIL and by AIR, its AIR quantity
    and its first line's price (stable l_orderkey order), the DOUBLE
    values rounded to the card's float32 plates."""
    import numpy as np

    f32 = lambda a: a.astype(np.float32).astype(np.float64)  # noqa: E731
    n = len(orders["o_orderkey"])
    ok = orders["o_orderkey"]
    key = li["l_orderkey"]
    order = np.argsort(key, kind="stable")
    lo = np.searchsorted(key[order], ok, side="left")
    lines = np.bincount(key, minlength=n + 2)[ok]
    mode = li["l_shipmode"]

    def per_order(w):
        return np.bincount(key, weights=w, minlength=n + 2)[ok]

    mail = per_order(mode == "MAIL") > 0
    has_air = per_order(mode == "AIR") > 0
    air = f32(per_order(li["l_quantity"] * (mode == "AIR")))
    price = f32(li["l_extendedprice"][order])
    first = np.where(lines > 0, price[np.minimum(lo, len(price) - 1)], 0.0)
    total = f32(orders["o_totalprice"])
    n1 = []
    for a in (False, True):
        for big in (False, True):
            m = mail & (has_air == a) & ((lines >= 4) == big)
            if m.any():
                n1.append((a, big, int(m.sum()), float(air[m].sum()),
                           int(lines[m].sum()), float(total[m].sum()),
                           float(first[m].max())))
    m2 = (lines >= 3) & (total > 100000)
    return n1, [(float(first[m2].sum()),)]


def complex_plate_bytes(data):
    """Bytes of the complex columns' plates in a table's device cache."""
    import torch

    total = 0
    for entry in list(data._device_cache.values()):
        for key, val in entry.items():
            if isinstance(key, tuple) and str(key[0]).startswith("_build_"):
                total += sum(t.numel() * t.element_size()
                             for t in torch.utils._pytree.tree_leaves(val)
                             if isinstance(t, torch.Tensor))
    return total


def nested_path(tpch, args):
    """Phase 18; returns the two kernels' launches over N1 and N2."""
    from snappydata_tpu_torch import SnappySession, config
    from snappydata_tpu_torch.catalog import Catalog

    props = config.global_properties()
    props.pallas_reduce = True
    props.pallas_group_reduce = True
    t0 = time.perf_counter()
    orders = tpch.gen_orders(NESTED_ORDERS, NESTED_ORDERS // 10, args.seed)
    li = tpch.gen_lineitem(NESTED_LINES, 7)
    nested = tpch.gen_orders_nested(orders, li)
    log(f"nested_gen_s {time.perf_counter() - t0:.3f} orders "
        f"{NESTED_ORDERS} lines {NESTED_LINES}")
    s = SnappySession(catalog=Catalog())
    s.sql(tpch.ORDERS_NESTED_DDL)
    t0 = time.perf_counter()
    s.insert_arrays("orders_nested", [nested[c] for c in NESTED_COLS])
    ing = time.perf_counter() - t0
    log(f"nested_ingest_s {ing:.3f} rows_per_s {NESTED_ORDERS / ing:.0f}")
    del nested
    want = dict(zip(("n1", "n2"), nested_oracle(orders, li)))
    del orders, li
    launches = {"grouped_reduce": 0, "masked_kahan_sum": 0}
    data = s.catalog.describe("orders_nested").data
    for name, sql, kname in (("n1", tpch.NESTED_N1, "grouped_reduce"),
                             ("n2", tpch.NESTED_N2, "masked_kahan_sum")):
        rows, f_s, w_s, moved, lc, calls, peak, resident = \
            timed_query(s, sql, args.reps)
        log(f"nested_{name} first_s {f_s:.4f} warm_s {w_s:.4f} counters "
            f"{json.dumps(moved)} launches {json.dumps(lc)} "
            f"peak_device_bytes {peak} resident_before_bytes {resident}")
        if moved["host_fallbacks"]:
            fail(f"nested {name} left the device")
        if lc[kname] < 1 + args.reps:
            fail(f"{kname} launched {lc[kname]} times over nested "
                 f"{name}'s {1 + args.reps} runs")
        for k in launches:
            launches[k] += lc[k]
        phase = grouped_phase if kname == "grouped_reduce" else kahan_phase
        log(f"kernel {kname} on nested {name} "
            f"{json.dumps(phase(calls[kname], args.reps))}")
        check_rows(f"nested {name} vs numpy", rows, want[name])
        log(f"nested_{name} {json.dumps(rows[:4])}")
        if args.profile:
            log(f"profile nested_{name} " + json.dumps(profile_run(
                lambda sql=sql: s.sql(sql).rows())))
    log(f"nested_complex_plate_bytes {complex_plate_bytes(data)}")
    log("answers ok: N1 / N2 over the nested orders match numpy")
    return launches


# --------------------------------------------------------------------------
# phase 19: durable lineitem (WAL, checkpoint, recovery, compaction)
# --------------------------------------------------------------------------

GROUP_COMMIT_THREADS = 4
GROUP_COMMIT_STMTS = 500
DURABLE_STMT_ROWS = 1 << 20


def _row_sql(rows, i, names):
    vals = []
    for k in names:
        v = rows[k][i]
        vals.append(f"'{v}'" if isinstance(v, str) else repr(v.item()))
    return "INSERT INTO lineitem VALUES (" + ", ".join(vals) + ")"


def durable_queries(s, tpch, want, args, what):
    """Q1 and Q6 once and --reps times warm on `s`, checked against
    `want`; (launches, compressed_fallback_deltas moved, the grouped
    kernel's last launch configuration)."""
    from snappydata_tpu_torch.observability.metrics import global_registry
    from snappydata_tpu_torch.ops import group_reduce as gr

    reg = global_registry()
    cf0 = reg.counter("compressed_fallback_deltas")
    fb0 = {k: v for k, v in reg.counters_snapshot().items()
           if k.startswith("compressed_fallback_")}
    launches = {"grouped_reduce": 0, "masked_kahan_sum": 0}
    cfg = None
    for name, sql in (("q1", tpch.Q1), ("q6", tpch.Q6)):
        rows, f_s, w_s, moved, lc, calls, peak, _res = \
            timed_query(s, sql, args.reps)
        log(f"durable_{what}_{name} first_s {f_s:.4f} warm_s {w_s:.4f} "
            f"counters {json.dumps(moved)} launches {json.dumps(lc)} "
            f"peak_device_bytes {peak}")
        if moved["host_fallbacks"]:
            fail(f"durable {what} {name} left the device")
        kname = "grouped_reduce" if name == "q1" else "masked_kahan_sum"
        if lc[kname] < 1 + args.reps:
            fail(f"{kname} launched {lc[kname]} times over durable {what} "
                 f"{name}'s {1 + args.reps} runs")
        if name == "q1":
            cfg = dict(gr.grouped_reduce.config)
        for k in launches:
            launches[k] += lc[k]
        phase = grouped_phase if kname == "grouped_reduce" else kahan_phase
        log(f"kernel {kname} on durable {what} {name} "
            f"{json.dumps(phase(calls[kname], args.reps))}")
        check_rows(f"durable {what} {name} vs numpy", rows, want[name])
        if args.profile:
            log(f"profile durable_{what}_{name} " + json.dumps(profile_run(
                lambda sql=sql: s.sql(sql).rows())))
    moved = {k: v - fb0.get(k, 0) for k, v in reg.counters_snapshot().items()
             if k.startswith("compressed_fallback_") and v != fb0.get(k, 0)}
    log(f"durable_{what} compressed_fallbacks {json.dumps(moved)}")
    return launches, reg.counter("compressed_fallback_deltas") - cf0, cfg


def durable_path(tpch, li, args, clean_ops):
    """Phase 19 (a) - (g) on the first 1 / DURABLE_DEPTH of lineitem's rows in
    a durable session under a temporary directory, then phase 20 on its
    third session; returns the two kernels' launches over 19 (e) - (g)
    and 20.  `clean_ops` is the grouped kernel's slot count on phase 4's
    unmutated Q1."""
    import shutil
    import tempfile
    import threading

    import numpy as np

    from snappydata_tpu_torch import SnappySession, config
    from snappydata_tpu_torch.catalog import Catalog
    from snappydata_tpu_torch.observability.metrics import global_registry
    from snappydata_tpu_torch.storage import compact
    from snappydata_tpu_torch.storage.encoding import compress_bytes

    props = config.global_properties()
    props.pallas_reduce = True
    props.pallas_group_reduce = True
    props.wal_fsync_mode = "group"
    reg = global_registry()
    d = tempfile.mkdtemp(prefix="chip_smoke_durable_")
    st = os.statvfs(d)
    log(f"durable_dir_free_bytes {st.f_bavail * st.f_frsize}")
    codec = compress_bytes(b"\0" * 1024, props.compression_codec)[0]
    log(f"durable_codec configured {props.compression_codec} used {codec}")
    try:
        n = len(li["l_orderkey"])
        names = list(li.keys())
        # (a) CREATE, then insert_arrays in 1,048,576-row statements
        s1 = SnappySession(catalog=Catalog(), data_dir=d, recover=False)
        s1.sql(tpch.LINEITEM_DDL)
        f0, w0 = reg.counter("wal_fsync_count"), \
            reg.counter("wal_bytes_written")
        t0 = time.perf_counter()
        for lo in range(0, n, DURABLE_STMT_ROWS):
            s1.insert_arrays("lineitem", [li[k][lo:lo + DURABLE_STMT_ROWS]
                                          for k in names])
        ing = time.perf_counter() - t0
        log(f"durable_ingest rows {n} s {ing:.3f} rows_per_s {n / ing:.0f}"
            f" wal_bytes {reg.counter('wal_bytes_written') - w0} "
            f"wal_fsync_count {reg.counter('wal_fsync_count') - f0}")
        # (b) checkpoint
        t0 = time.perf_counter()
        s1.checkpoint()
        ck = time.perf_counter() - t0
        disk = sum(os.path.getsize(os.path.join(r, f))
                   for r, _d, fs in os.walk(d) for f in fs)
        log(f"durable_checkpoint s {ck:.3f} bytes_on_disk {disk} codec "
            f"{codec}")
        # (c) journaled UPDATE, DELETE and one insert
        times = {}
        for what, sql in (("update", MUTATION_UPDATE),
                          ("delete", MUTATION_DELETE)):
            t0 = time.perf_counter()
            cnt = int(s1.sql(sql).rows()[0][0])
            times[what] = (time.perf_counter() - t0, cnt)
        extra = tpch.gen_lineitem(MUTATION_INSERT_ROWS, args.seed + 3)
        t0 = time.perf_counter()
        s1.insert_arrays("lineitem", [extra[k] for k in names])
        times["insert"] = (time.perf_counter() - t0, MUTATION_INSERT_ROWS)
        log("durable_mutations " + " ".join(
            f"{k}_s {v[0]:.3f} {k}_rows {v[1]}" for k, v in times.items()))
        # (d) group commit: threads of single-row INSERT statements
        single = tpch.gen_lineitem(GROUP_COMMIT_THREADS * GROUP_COMMIT_STMTS,
                                   args.seed + 20)
        stmts = [_row_sql(single, i, names)
                 for i in range(GROUP_COMMIT_THREADS * GROUP_COMMIT_STMTS)]
        f0 = reg.counter("wal_fsync_count")
        g0 = reg.counter("wal_group_commit_batches")
        errors = []

        def committer(w):
            try:
                for sql in stmts[w::GROUP_COMMIT_THREADS]:
                    s1.sql(sql)
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(e)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=committer, args=(w,))
                   for w in range(GROUP_COMMIT_THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        gc_s = time.perf_counter() - t0
        if errors:
            fail(f"group commit: {errors[0]!r}")
        log(f"durable_group_commit statements {len(stmts)} threads "
            f"{GROUP_COMMIT_THREADS} s {gc_s:.3f} acks_per_s "
            f"{len(stmts) / gc_s:.0f} wal_fsync_count "
            f"{reg.counter('wal_fsync_count') - f0} "
            f"wal_group_commit_batches "
            f"{reg.counter('wal_group_commit_batches') - g0}")
        tail = {k: np.concatenate([extra[k], single[k]]) for k in names}
        mut, _u, _d = mutated_lineitem(
            li, flag_status_code(li["l_returnflag"], li["l_linestatus"]),
            tail, tpch)
        want = oracle(mut, tpch)
        del mut, tail
        # (e) crash-shape reopen: s1 stays open
        launches = {"grouped_reduce": 0, "masked_kahan_sum": 0}
        t0 = time.perf_counter()
        s2 = SnappySession(data_dir=d)
        log(f"durable_recovery_s {time.perf_counter() - t0:.3f}")
        lc, cf, _cfg = durable_queries(s2, tpch, want, args, "recovered")
        log(f"durable_recovered compressed_fallback_deltas moved {cf}")
        if cf < 1:
            fail("the recovered l_discount kept its encoded form")
        for k in launches:
            launches[k] += lc[k]
        # (f) compaction of the recovered lineitem
        data = s2.catalog.describe("lineitem").data
        t0 = time.perf_counter()
        out = compact.run_compaction_pass(data, force=True)
        log(f"durable_compaction s {time.perf_counter() - t0:.3f} "
            f"batches_rewritten {out['rewritten']} produced "
            f"{out['produced']} reclaimed_bytes {out['reclaimed_bytes']}")
        if out["rewritten"] < 1:
            fail(f"compaction rewrote nothing: {out}")
        lc, cf, cfg = durable_queries(s2, tpch, want, args, "compacted")
        log(f"durable_compacted compressed_fallback_deltas moved {cf} "
            f"grouped_reduce_config {json.dumps(cfg)}")
        if cf:
            fail("a compacted column still bound with its delta")
        for k in launches:
            launches[k] += lc[k]
        # (g) a third crash-shape reopen answers the same
        t0 = time.perf_counter()
        s3 = SnappySession(data_dir=d)
        log(f"durable_recovery_again_s {time.perf_counter() - t0:.3f}")
        lc, _cf, _cfg = durable_queries(s3, tpch, want, args, "reopened")
        for k in launches:
            launches[k] += lc[k]
        log("answers ok: the recovered, compacted and reopened lineitem "
            "match numpy")
        # phase 20 on s3 alone: the first two sessions' tables would sum
        # into the broker's lineitem line and walk the ladder beside it
        for s in (s1, s2):
            s.disk_store.close()
        del s1, s2, data
        import gc

        import torch

        gc.collect()
        torch.cuda.empty_cache()
        g_launches = governed_path(s3, tpch, want, args, clean_ops)
        log(f"governed_path_launches {json.dumps(g_launches)}")
        log("answers ok: Q1 / Q6 over demoted, disk-tier, healed, admitted "
            "and compacted lineitem match numpy; the storm is accounted")
        for k in launches:
            launches[k] += g_launches[k]
        s3.disk_store.close()
        return launches
    finally:
        shutil.rmtree(d, ignore_errors=True)


# --------------------------------------------------------------------------
# phase 20: the resource governor, the tier ladder, self-healing, the
# fault storm and the broker-kicked compactor, on phase 19's s3
# --------------------------------------------------------------------------

STORM_ROUNDS = 26
STORM_SEED = 1717
# writes each value back unchanged: deltas on a seventh of the orders,
# the oracle untouched
COMPACTION_UPDATE = ("UPDATE lineitem SET l_discount = l_discount "
                     "WHERE l_orderkey % 7 = 0")


def _mem(what):
    """One line of the card's allocator figures beside the broker's
    ledger and the process RSS."""
    import torch

    from snappydata_tpu_torch.resource import global_broker
    from snappydata_tpu_torch.storage import hoststore

    torch.cuda.synchronize()
    led = global_broker().ledger()
    out = {"ledger_host": led["host"], "ledger_device": led["device"],
           "host_total": led["host_total"],
           "device_total": led["device_total"],
           "tier_file_bytes": led["tier_file_bytes"],
           "spill_file_bytes": led["spill_file_bytes"],
           "retained_epoch_bytes": led["retained_epoch_bytes"],
           "memory_allocated": torch.cuda.memory_allocated(),
           "memory_reserved": torch.cuda.memory_reserved(),
           "rss": hoststore.process_rss_bytes()}
    log(f"governed_{what} {json.dumps(out)}")
    return out


def _drop_leftover_registrations(s):
    """Unregister from the broker every table that is not one of `s`'s:
    tables of earlier phases whose sessions the script let go but that a
    lingering reference keeps alive would otherwise sum into phase 20's
    ledger lines and walk the ladder beside s's lineitem.  Each one is
    logged with what refers to it."""
    import gc

    from snappydata_tpu_torch.resource import global_broker

    broker = global_broker()
    mine = {id(i.data) for i in s.catalog.list_tables()}
    with broker._tables_lock:
        regs = [(k, r()) for k, r in broker._tables.items()]
    for (owner, name), data in regs:
        if data is None or id(data) in mine:
            continue
        refs = sorted({type(r).__name__ for r in gc.get_referrers(data)})
        rows = data.snapshot().total_rows() \
            if hasattr(data, "snapshot") else None
        log(f"governed_leftover table {name} owner {owner} rows {rows} "
            f"referrers {refs}")
        broker.unregister_table(name, owner)


def _settled_allocated():
    """memory_allocated once the card is idle and the caching allocator
    retired blocks whose record_stream events completed."""
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize()
    probe = torch.empty(1, device="cuda")
    del probe
    return torch.cuda.memory_allocated()


def _launch_sum(total, lc):
    for k in total:
        total[k] += lc[k]


def _tiled_q1(s, tpch, want, args, what, budget, total):
    """Tiled Q1 at `budget`, once and --reps times warm; rows, tiles and
    rows/s."""
    from snappydata_tpu_torch import config
    from snappydata_tpu_torch.observability.metrics import global_registry

    props = config.global_properties()
    saved = props.scan_tile_bytes
    reg = global_registry()
    t0 = reg.counter("scan_tiles")
    props.scan_tile_bytes = budget
    try:
        rows, f_s, w_s, moved, lc, _calls, peak, res = \
            timed_query(s, tpch.Q1, args.reps)
    finally:
        props.scan_tile_bytes = saved
    tiles = reg.counter("scan_tiles") - t0
    n = s.catalog.describe("lineitem").data.snapshot().total_rows()
    log(f"governed_{what}_tiled_q1 first_s {f_s:.4f} warm_s {w_s:.4f} "
        f"rows_per_s {n / w_s:.0f} tiles {tiles} launches {json.dumps(lc)} "
        f"peak_above_resident {peak - res}")
    if moved["host_fallbacks"]:
        fail(f"tiled Q1 ({what}) left the device")
    if lc["grouped_reduce"] < tiles:
        fail(f"grouped_reduce launched {lc['grouped_reduce']} times over "
             f"{tiles} tiles ({what})")
    check_rows(f"tiled Q1 ({what}) vs numpy", rows, want["q1"])
    _launch_sum(total, lc)
    return w_s


def _q1_q6(s, tpch, want, args, what, total):
    """Q1 and Q6 once and --reps times warm, both kernels launched,
    answers against numpy."""
    from snappydata_tpu_torch.observability.metrics import global_registry

    reg = global_registry()
    for name, sql in (("q1", tpch.Q1), ("q6", tpch.Q6)):
        fb0 = {k: v for k, v in reg.counters_snapshot().items()
               if k.startswith("compressed_fallback_")}
        rows, f_s, w_s, moved, lc, _calls, _peak, _res = \
            timed_query(s, sql, args.reps)
        fb = {k: v - fb0.get(k, 0) for k, v in reg.counters_snapshot().items()
              if k.startswith("compressed_fallback_")
              and v != fb0.get(k, 0)}
        log(f"governed_{what}_{name} first_s {f_s:.4f} warm_s {w_s:.4f} "
            f"launches {json.dumps(lc)} compressed_fallbacks "
            f"{json.dumps(fb)}")
        if moved["host_fallbacks"]:
            fail(f"{what} {name} left the device")
        kname = "grouped_reduce" if name == "q1" else "masked_kahan_sum"
        if lc[kname] < 1 + args.reps:
            fail(f"{kname} launched {lc[kname]} times over {what} {name}'s "
                 f"{1 + args.reps} runs")
        check_rows(f"{what} {name} vs numpy", rows, want[name])
        _launch_sum(total, lc)


def _cancel_tiled(s, tpch, budget, by_timeout):
    """A tiled Q1 on a thread, stopped by cancel() after its first tile
    (or by query_timeout_s): (tiles run, tiles of the pass, ms from the
    cancel to the raise, memory_allocated before and after)."""
    import threading

    from snappydata_tpu_torch import config, resource
    from snappydata_tpu_torch.observability.metrics import global_registry
    from snappydata_tpu_torch.storage import mvcc, prefetch

    props = config.global_properties()
    reg = global_registry()
    data = s.catalog.describe("lineitem").data
    units, _ub, tu, tiles = tile_plan(s, "lineitem", Q1_COLS, budget)
    saved = (props.scan_tile_bytes, props.query_timeout_s)
    props.scan_tile_bytes = budget
    before = _settled_allocated()
    t0 = reg.counter("scan_tiles")
    out = {}

    def run():
        try:
            s.sql(tpch.Q1)
            out["err"] = None
        except Exception as e:  # noqa: BLE001 - checked below
            out["err"] = e
        out["raised"] = time.perf_counter()

    try:
        if by_timeout:
            props.query_timeout_s = TIMEOUT_S
        th = threading.Thread(target=run)
        th.start()
        if not by_timeout:
            deadline = time.monotonic() + 60
            while reg.counter("scan_tiles") == t0 and th.is_alive() \
                    and time.monotonic() < deadline:
                time.sleep(0.0005)
            qid = [q["id"] for q in resource.global_broker().queries()
                   if q["sql"] == tpch.Q1]
            if not qid:
                fail("the tiled Q1 was not registered with the broker")
            t_cancel = time.perf_counter()
            resource.global_broker().cancel(qid[0], "cancelled by "
                                            "chip_smoke")
        else:
            t_cancel = time.perf_counter()
        th.join(120)
    finally:
        props.scan_tile_bytes, props.query_timeout_s = saved
    err = out.get("err")
    if not isinstance(err, resource.CancelException) \
            or "XCL52" not in str(err):
        fail(f"the tiled Q1 was not cancelled: {err!r}")
    # the error joins its request's trace, which the ring holds
    from snappydata_tpu_torch.observability import tracing

    got = tracing.ring().get(err.trace_id) if err.trace_id else []
    if not got or got[0]["status"] != "error":
        fail(f"the cancel's trace id {err.trace_id!r} is not an error "
             f"trace in the ring")
    log(f"cancel trace_id {err.trace_id} spans {got[0]['spans']}")
    ran = reg.counter("scan_tiles") - t0
    if ran >= tiles:
        fail(f"the cancelled pass ran all {tiles} tiles")
    if s._in_tile or mvcc.has_pins(data) or prefetch.keep_windows(data):
        fail("the cancelled pass left its tile flag, pin or windows")
    if any(q["sql"] == tpch.Q1 for q in resource.global_broker().queries()):
        fail("the cancelled query is still registered")
    after = _settled_allocated()
    return ran, tiles, (out["raised"] - t_cancel) * 1e3, before, after


TIMEOUT_S = 0.05


def governed_path(s, tpch, want, args, clean_ops):
    """Phase 20 (a) - (h) on phase 19's third session `s` (durable
    lineitem, `want` its oracle); returns the two kernels' launches."""
    import shutil
    import tempfile

    from snappydata_tpu_torch import config, resource
    from snappydata_tpu_torch.observability.metrics import global_registry
    from snappydata_tpu_torch.reliability import failpoints as rfail
    from snappydata_tpu_torch.reliability import faultstorm
    from snappydata_tpu_torch.storage import compact, hoststore, mvcc
    from snappydata_tpu_torch.storage import persistence, tier

    props = config.global_properties()
    reg = global_registry()
    broker = resource.global_broker()
    data = s.catalog.describe("lineitem").data
    total = {"grouped_reduce": 0, "masked_kahan_sum": 0}
    units, ub, _tu, _t = tile_plan(s, "lineitem", Q1_COLS, 1)
    budget = units * ub // 10
    _drop_leftover_registrations(s)

    # (a) the ledger after warm Q1 / Q6 (phase 19 (g) ran them)
    mem_a = _mem("a_ledger")

    # (b) HBM -> host: tier_device_bytes below the bound plates, a tiled
    # Q1, and maybe_demote once the statement's pin is released
    dev_bytes = mem_a["ledger_device"].get("lineitem", 0)
    entries0 = len(data._device_cache)
    props.tier_device_bytes = max(1, dev_bytes // 4)
    h0 = reg.counter("tier_demotions_hbm")
    alloc0 = _settled_allocated()
    try:
        _tiled_q1(s, tpch, want, args, "b", budget, total)
    finally:
        props.tier_device_bytes = 0
    alloc1 = _settled_allocated()
    mem_b = _mem("b_after_hbm_demotion")
    dropped = reg.counter("tier_demotions_hbm") - h0
    log(f"governed_b entries_before {entries0} entries_dropped {dropped} "
        f"ledger_device_before {dev_bytes} ledger_device_after "
        f"{mem_b['ledger_device'].get('lineitem', 0)} "
        f"memory_allocated_before {alloc0} after {alloc1}")
    if dropped < 1:
        fail("maybe_demote dropped no device entry")

    # (c) host -> disk: tier_host_bytes at a quarter of the table's host
    # bytes, so about three quarters of the batches are framed
    host0 = mem_b["ledger_host"]["lineitem"]
    props.tier_host_bytes = host0 // 4
    d0, f0 = reg.counter("tier_demotions_host"), tier.tier_file_bytes()
    t0 = time.perf_counter()
    try:
        tier.maybe_demote()
    finally:
        props.tier_host_bytes = 0
    dem_s = time.perf_counter() - t0
    fbytes = tier.tier_file_bytes() - f0
    nb = reg.counter("tier_demotions_host") - d0
    views = len(data.snapshot().views)
    if nb > views:
        fail(f"host -> disk framed {nb} batches, the table has {views}")
    log(f"governed_c demoted_batches {nb} of {views} s {dem_s:.3f} "
        f"tier_file_bytes {fbytes} gb_per_s {fbytes / dem_s / 1e9:.3f}")
    if nb < views // 2:
        fail(f"host -> disk framed {nb} of {views} batches")
    _mem("c_after_disk_demotion")
    _q1_q6(s, tpch, want, args, "c_disk_tier", total)
    _tiled_q1(s, tpch, want, args, "c_disk_tier", budget, total)

    # (d) promote, then heal one corrupted tier record from the durable
    # store's checkpointed batch file
    t0 = time.perf_counter()
    promoted = tier.promote_table(data)
    log(f"governed_d promote_table batches {promoted} s "
        f"{time.perf_counter() - t0:.3f}")
    if promoted < nb:
        fail(f"promote_table brought back {promoted} of {nb} batches")
    first = data.snapshot().views[0].batch
    one = hoststore.batch_resident_bytes(first)
    q0, r0 = reg.counter("tier_quarantined_files"), \
        reg.counter("tier_rebuilds")
    rfail.arm("tier.write", "corrupt_bytes", param=4, count=1)
    try:
        tier.demote_host([("lineitem", data)], 4 * one)
    finally:
        rfail.clear()
    # no resident twin in a retained epoch: the rebuild must come from
    # the checkpointed batch files
    mvcc.trim_unpinned([("lineitem", data)])
    loads = []
    orig_load = persistence.DiskStore.load_batch

    def counted_load(self, table, batch_id):
        got = orig_load(self, table, batch_id)
        loads.append((table, batch_id, got is not None))
        return got

    persistence.DiskStore.load_batch = counted_load
    try:
        t0 = time.perf_counter()
        healed = tier.promote_table(data)
        heal_s = time.perf_counter() - t0
    finally:
        persistence.DiskStore.load_batch = orig_load
    dq = reg.counter("tier_quarantined_files") - q0
    dr = reg.counter("tier_rebuilds") - r0
    log(f"governed_d heal batches {healed} s {heal_s:.3f} quarantined {dq} "
        f"rebuilds {dr} load_batch {json.dumps(loads)}")
    if dq != 1 or dr != 1 or not any(ok for _t, _b, ok in loads):
        fail("the corrupted record was not quarantined and rebuilt from "
             "DiskStore.load_batch")
    _q1_q6(s, tpch, want, args, "d_healed", total)

    # (e) admission: reject below the estimate (no launch), the ladder
    # under a limit just above the measured residency, a limit of one
    # tile admitting the tiled Q1
    from snappydata_tpu_torch.ops import group_reduce as gr
    from snappydata_tpu_torch.ops import kahan_reduce as kr
    from snappydata_tpu_torch.sql.parser import parse

    with config.device_scope(s.device):   # DOUBLE plates at f32 there
        est = resource.estimate_statement_bytes(s.catalog, parse(tpch.Q1))
    gr.grouped_reduce.launches = kr.masked_kahan_sum.launches = 0
    rej0 = reg.counter("governor_rejected")
    props.memory_limit_bytes = est // 2
    try:
        s.sql(tpch.Q1)
        fail("Q1 under half its estimate was admitted")
    except resource.LowMemoryException as e:
        if "XCL54" not in str(e):
            fail(f"the rejection carries no XCL54: {e}")
        log(f"governed_e rejected estimate {est} limit {est // 2} "
            f"launches {gr.grouped_reduce.launches + kr.masked_kahan_sum.launches}"
            f" error {str(e)[:80]!r}")
    finally:
        props.memory_limit_bytes = 0
    if gr.grouped_reduce.launches or kr.masked_kahan_sum.launches:
        fail("a rejected query launched a kernel")
    if reg.counter("governor_rejected") != rej0 + 1:
        fail("governor_rejected did not move")
    host, device = broker.measured_bytes()
    deg0 = {k: v for k, v in reg.counters_snapshot().items()
            if k.startswith("governor_degrade_")}
    props.memory_limit_bytes = int((host + device) * 1.05)
    try:
        t0 = time.perf_counter()
        _tiled_q1(s, tpch, want, args, "e_ladder", budget, total)
        lad_s = time.perf_counter() - t0
    finally:
        props.memory_limit_bytes = 0
    deg = {k: v - deg0.get(k, 0) for k, v in reg.counters_snapshot().items()
           if k.startswith("governor_degrade_") and v != deg0.get(k, 0)}
    log(f"governed_e ladder measured {host + device} limit "
        f"{int((host + device) * 1.05)} s {lad_s:.3f} counters "
        f"{json.dumps(deg)}")
    if not deg:
        fail("the ladder recorded no governor_degrade_* counter")
    _mem("e_after_ladder")
    deg0 = {k: v for k, v in reg.counters_snapshot().items()
            if k.startswith("governor_degrade_")}
    props.memory_limit_bytes = int(budget * 1.25)
    try:
        t0 = time.perf_counter()
        _tiled_q1(s, tpch, want, args, "e_one_tile_limit", budget, total)
        one_s = time.perf_counter() - t0
    finally:
        props.memory_limit_bytes = 0
    deg = {k: v - deg0.get(k, 0) for k, v in reg.counters_snapshot().items()
           if k.startswith("governor_degrade_") and v != deg0.get(k, 0)}
    log(f"governed_e one_tile limit {int(budget * 1.25)} s {one_s:.3f} "
        f"counters {json.dumps(deg)}")
    _mem("e_after_one_tile_limit")

    # (f) cancel after the first tile, then query_timeout_s
    small = max(budget // 4, ub)
    for how in ("cancel", "timeout"):
        ran, tiles, ms, before, after = _cancel_tiled(
            s, tpch, small, how == "timeout")
        log(f"governed_f {how} tiles_run {ran} of {tiles} "
            f"cancel_to_raise_ms {ms:.2f} memory_allocated_before {before}"
            f" after {after}")
        if after > before:
            import gc

            import torch

            live = sorted((o.untyped_storage().nbytes(), tuple(o.shape))
                          for o in gc.get_objects()
                          if torch.is_tensor(o) and o.is_cuda)
            fail(f"the {how}led pass left {after - before} bytes allocated; "
                 f"largest live tensors {live[-6:]}")
    _q1_q6(s, tpch, want, args, "f_after_cancel", total)

    # (g) the seeded fault storm over a small durable table
    sd = tempfile.mkdtemp(prefix="chip_smoke_storm_")
    t0 = time.perf_counter()
    try:
        res = faultstorm.run_storm(sd, seed=STORM_SEED, rounds=STORM_ROUNDS,
                                   device=s.device)
    finally:
        shutil.rmtree(sd, ignore_errors=True)
    storm_s = time.perf_counter() - t0
    log(f"governed_g storm s {storm_s:.3f} " + json.dumps(
        {k: res[k] for k in ("rounds", "injected", "recovered",
                             "typed_errors", "recovery_ratio",
                             "value_mismatches", "crash_recoveries",
                             "rows_final", "fired_by_point", "tier",
                             "prefetch")}))
    if res["recovery_ratio"] != 1.0 or res["value_mismatches"] \
            or res["unexpected"]:
        fail(f"fault storm: {res['unexpected'][:3]}")

    # (h) the broker-kicked compactor: an UPDATE that writes values back
    # (a Q1 binds its deltas and tallies them on the table), then the
    # next admission kicks one background sweep
    t0 = time.perf_counter()
    cnt = int(s.sql(COMPACTION_UPDATE).rows()[0][0])
    log(f"governed_h update rows {cnt} s {time.perf_counter() - t0:.3f}")
    cf0 = reg.counter("compressed_fallback_deltas")
    check_rows("Q1 over the updated lineitem vs numpy",
               s.sql(tpch.Q1).rows(), want["q1"])
    if reg.counter("compressed_fallback_deltas") == cf0:
        fail("the UPDATE left no delta for the sweep to fold")
    props.compaction_enabled = True
    compact._last_pass = 0.0
    sw0, p0 = reg.counter("compaction_sweeps"), \
        reg.counter("compaction_passes")
    t0 = time.perf_counter()
    try:
        s.sql("SELECT count(*) FROM lineitem")
        if not compact.wait_idle(600):
            fail("the background compaction sweep did not finish")
    finally:
        props.compaction_enabled = False
    sweep_s = time.perf_counter() - t0
    log(f"governed_h sweeps {reg.counter('compaction_sweeps') - sw0} "
        f"passes {reg.counter('compaction_passes') - p0} s {sweep_s:.3f}")
    if reg.counter("compaction_sweeps") != sw0 + 1 \
            or reg.counter("compaction_passes") < p0 + 1:
        fail("admission did not kick one background compaction sweep")
    cf0 = reg.counter("compressed_fallback_deltas")
    _q1_q6(s, tpch, want, args, "h_compacted", total)
    cfg = dict(gr.grouped_reduce.config or {})
    log(f"governed_h compressed_fallback_deltas moved "
        f"{reg.counter('compressed_fallback_deltas') - cf0} "
        f"grouped_reduce_config {json.dumps(cfg)}")
    if reg.counter("compressed_fallback_deltas") != cf0:
        fail("a compacted column still bound with its delta")
    if cfg.get("ops") != clean_ops:
        fail(f"compacted Q1 ran {cfg.get('ops')} slots, the unmutated "
             f"table's Q1 {clean_ops}")
    _mem("h_end")
    return total


# -- phase 25: the front doors (Flight, Flight SQL, REST, the client) -------

FRONT_DOOR_REQUESTS = 256     # (f): Q6 requests a client level, each way
PUT_ROWS = 1 << 20            # (d): rows ingested through do_put
STREAM_SCAN = ("SELECT l_orderkey, l_extendedprice FROM lineitem "
               "WHERE l_quantity < 2 LIMIT 1000")


def _arrow_rows(tbl):
    """An Arrow table's rows as tuples, as `Result.rows()` gives them."""
    cols = [c.to_pylist() for c in tbl.columns]
    return [tuple(r) for r in zip(*cols)]


def _http(svc, path, body=None):
    import urllib.request

    req = urllib.request.Request(
        f"http://{svc.host}:{svc.port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        raw = r.read()
    return raw if path.startswith("/metrics/prometheus") else json.loads(raw)


def _served_once(fn, kernel):
    """Run `fn` with the launch counters at 0: (its value, seconds, the
    counts); fails unless `kernel` launched exactly once and the other
    kernel not at all."""
    import torch

    torch.cuda.synchronize()
    _reset_kernel_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    lc = _kernel_counts()
    want = {k: int(k == kernel) for k in lc}
    if lc != want:
        fail(f"a served query launched {lc}, expected {want}")
    return out, dt, lc


def flight_clients(address, binds, n_clients):
    """`n_clients` threads, each with its own SnappyClient, running its
    binds of SERVING_Q6 one after the other through Flight (`prepared`:
    the server's serving registry and micro-batcher): (answers, per-
    request seconds, wall seconds)."""
    import threading

    from snappydata_tpu_torch.cluster.client import SnappyClient

    answers, lat, errors = {}, [], []
    barrier = threading.Barrier(n_clients)

    def client(c):
        cl = SnappyClient(address=address)
        try:
            cl.ping()
            barrier.wait(timeout=120)
            for i, b in enumerate(binds[c]):
                t0 = time.perf_counter()
                answers[(c, i)] = _arrow_rows(
                    cl.sql(SERVING_Q6, params=list(b), prepared=True))
                lat.append(time.perf_counter() - t0)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(f"{type(e).__name__}: {e}")
        finally:
            cl.close()

    ts = [threading.Thread(target=client, args=(c,), daemon=True)
          for c in range(n_clients)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in ts):
        fail(f"a Flight client of {n_clients} hung")
    if errors:
        fail(f"Flight clients raised: {errors[:3]}")
    return answers, lat, wall


def front_door_path(session, tpch, args):
    """Phase 25 (a) - (f) on the main session as phase 24 leaves it: one
    SnappyFlightServer and one RestService over it on 127.0.0.1, port 0.
    Returns the two kernels' launches and (a)'s warm seconds of the Flight
    Q1 and Q6 ({"q1": s, "q6": s})."""
    import threading

    import numpy as np
    import pyarrow as pa
    import torch

    from snappydata_tpu_torch import config
    from snappydata_tpu_torch.cluster import flight_server
    from snappydata_tpu_torch.cluster.client import SnappyClient
    from snappydata_tpu_torch.cluster.flightsql import FlightSqlClient
    from snappydata_tpu_torch.cluster.rest import RestService
    from snappydata_tpu_torch.observability import (TableStatsService,
                                                    tracing)
    from snappydata_tpu_torch.observability.metrics import global_registry
    from snappydata_tpu_torch.resource.broker import global_broker

    props = config.global_properties()
    props.pallas_reduce = True
    props.pallas_group_reduce = True
    reg = global_registry()
    total = {"grouped_reduce": 0, "masked_kahan_sum": 0}
    flight_warm = {}
    t_phase = time.perf_counter()
    srv = flight_server.SnappyFlightServer(session)
    threading.Thread(target=srv.serve, daemon=True).start()
    srv.wait_ready()
    address = f"127.0.0.1:{srv.port}"
    svc = RestService(session, TableStatsService(session.catalog)).start()
    client = SnappyClient(address=address)
    fsql = FlightSqlClient(address)
    try:
        # (a) Q1 and Q6 through SnappyClient.sql, first and --reps warm,
        # bit for bit the session's rows, one launch each
        q1_tid = None
        for name, q, kernel in (("q1", tpch.Q1, "grouped_reduce"),
                                ("q6", tpch.Q6, "masked_kahan_sum")):
            local = session.sql(q).rows()
            direct = []
            for _ in range(args.reps):
                _, dt, _ = _served_once(lambda q=q: session.sql(q).rows(),
                                        kernel)
                direct.append(dt)
            times = []
            for i in range(1 + args.reps):
                if name == "q1" and i == 1:
                    # the client mints the request's trace id, the
                    # server records its own trace under it: (e) reads
                    # it back through REST
                    with tracing.request_scope(q, kind="client") as tr:
                        tbl, dt, lc = _served_once(
                            lambda q=q: client.sql(q), kernel)
                    if tr is None:
                        fail("tracing is off: the Flight Q1 has no trace")
                    q1_tid = tr.trace_id
                else:
                    tbl, dt, lc = _served_once(lambda q=q: client.sql(q),
                                               kernel)
                _launch_sum(total, lc)
                times.append(dt)
                if _arrow_rows(tbl) != local:
                    fail(f"Flight {name}: {_arrow_rows(tbl)} != "
                         f"session.sql's {local}")
            warm = sorted(times[1:])[len(times[1:]) // 2]
            dwarm = sorted(direct)[len(direct) // 2]
            flight_warm[name] = warm
            log(f"front_door flight_{name} first_s {times[0]:.4f} warm_s "
                f"{warm:.4f} direct_warm_s {dwarm:.4f} front_door_ms "
                f"{(warm - dwarm) * 1e3:.2f} rows {len(local)} equal True "
                f"launches_per_run 1 {kernel}")

        # (b) Flight SQL: the statement Q6, GetTables, a prepared Q6 with
        # five binds (the second execute a serving-registry hit)
        local6 = session.sql(tpch.Q6).rows()
        tbl, dt, lc = _served_once(lambda: fsql.execute(tpch.Q6),
                                   "masked_kahan_sum")
        _launch_sum(total, lc)
        if _arrow_rows(tbl) != local6:
            fail(f"Flight SQL Q6 {_arrow_rows(tbl)} != {local6}")
        tables = [v.as_py() for v in fsql.get_tables().column("table_name")]
        if "lineitem" not in tables:
            fail(f"Flight SQL GetTables lacks lineitem: {tables}")
        binds = [q6_bind(tpch, y, b) for y, b in (
            (1994, (0.05, 0.07)), (1995, (0.02, 0.04)), (1996, (0.06, 0.08)),
            (1997, (0.03, 0.05)), (1993, (0.05, 0.07)))]
        ps = fsql.prepare(SERVING_Q6)
        in_process = session.prepare(SERVING_Q6)
        times, hits = [], []
        for b in binds:
            h0 = reg.counter("serving_prepared_hits")
            tbl, dt, lc = _served_once(lambda b=b: ps.execute(list(b)),
                                       "masked_kahan_sum")
            _launch_sum(total, lc)
            hits.append(reg.counter("serving_prepared_hits") - h0)
            times.append(dt)
            want = in_process.execute(b).rows()
            if _arrow_rows(tbl) != want:
                fail(f"Flight SQL prepared Q6 {b}: {_arrow_rows(tbl)} != "
                     f"{want}")
        ps.close()
        if hits[1] < 1:
            fail(f"the second prepared execute moved serving_prepared_hits "
                 f"by {hits[1]}")
        log(f"front_door flightsql q6_s {dt:.4f} get_tables {len(tables)} "
            f"prepared executes {len(binds)} first_s {times[0]:.4f} "
            f"warm_s {sorted(times[1:])[2]:.4f} serving_hits {hits} "
            f"launches_per_execute 1 masked_kahan_sum")

        # (c) a streamed scan with its LIMIT early stop
        batches = len(session.catalog.describe("lineitem").data.snapshot()
                      .views)
        decoded = [0]
        real_chunks = flight_server.iter_table_chunks

        def counting_chunks(sess, table):
            for chunk in real_chunks(sess, table):
                decoded[0] += 1
                yield chunk

        c0 = {k: reg.counter(k) for k in ("stream_scan_chunks",
                                          "stream_scan_early_stops")}
        flight_server.iter_table_chunks = counting_chunks
        try:
            t0 = time.perf_counter()
            tbl = client.sql(STREAM_SCAN)
            scan_s = time.perf_counter() - t0
        finally:
            flight_server.iter_table_chunks = real_chunks
        moved = {k: reg.counter(k) - v for k, v in c0.items()}
        want = session.sql(STREAM_SCAN).rows()
        if tbl.num_rows != 1000 or _arrow_rows(tbl) != want:
            fail(f"streamed scan: {tbl.num_rows} rows, equal to session.sql "
                 f"{_arrow_rows(tbl) == want}")
        if moved["stream_scan_early_stops"] != 1:
            fail(f"streamed scan did not stop early: {moved}")
        log(f"front_door stream_scan s {scan_s:.4f} rows {tbl.num_rows} "
            f"stream_scan_early_stops {moved['stream_scan_early_stops']} "
            f"stream_scan_chunks {moved['stream_scan_chunks']} "
            f"batches_decoded {decoded[0]} of {batches}")

        # (d) do_put of PUT_ROWS lineitem-shaped rows, then Q6 over them
        put = tpch.gen_lineitem(PUT_ROWS, args.seed + 11)
        arrow = pa.table({k: pa.array(v) for k, v in put.items()})
        session.sql(tpch.LINEITEM_DDL.replace("TABLE lineitem",
                                              "TABLE lineitem_put"))
        t0 = time.perf_counter()
        client.insert("lineitem_put", arrow)
        put_s = time.perf_counter() - t0
        q6_put = tpch.Q6.replace("lineitem", "lineitem_put")
        tbl, dt, lc = _served_once(lambda: client.sql(q6_put),
                                   "masked_kahan_sum")
        _launch_sum(total, lc)
        check_rows("Flight Q6 over the do_put table", _arrow_rows(tbl),
                   oracle(put, tpch)["q6"])
        log(f"front_door do_put rows {PUT_ROWS} s {put_s:.3f} rows_per_s "
            f"{PUT_ROWS / put_s:.0f} q6_s {dt:.4f} equal_numpy True")
        del put, arrow

        # (e) REST: /sql through serving_sql, a /jobs Q1, the storage and
        # scan routes, Prometheus, the trace of (a)'s Flight Q1
        h0 = reg.counter("serving_prepared_hits")
        for i in range(2):
            body, dt, lc = _served_once(
                lambda: _http(svc, "/sql", {"sql": tpch.Q6}),
                "masked_kahan_sum")
            _launch_sum(total, lc)
            if [tuple(r) for r in body["rows"]] != local6:
                fail(f"REST /sql Q6 {body['rows']} != {local6}")
        rest_hits = reg.counter("serving_prepared_hits") - h0
        if rest_hits < 1 or not body.get("trace_id"):
            fail(f"REST /sql: serving hits {rest_hits}, body {body}")
        local1 = session.sql(tpch.Q1).rows()
        _reset_kernel_counts()
        t0 = time.perf_counter()
        job = _http(svc, "/jobs", {"sql": tpch.Q1})["jobId"]
        for _ in range(6000):
            st = _http(svc, f"/jobs/{job}")
            if st["status"] in ("FINISHED", "ERROR"):
                break
            time.sleep(0.005)
        job_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        lc = _kernel_counts()
        _launch_sum(total, lc)
        if st["status"] != "FINISHED" or \
                [tuple(r) for r in st["rows"]] != local1 \
                or lc["grouped_reduce"] != 1:
            fail(f"REST job Q1: {st.get('status')} {st.get('error')}, "
                 f"launches {lc}")
        import gc

        gc.collect()
        storage = _http(svc, "/status/api/v1/storage")
        scan = _http(svc, "/status/api/v1/scan")
        stats_dev = {t: m["device_resident_bytes"]
                     for t, m in scan["tables"].items()}
        ledger = global_broker().ledger()["device"]
        for t, b in stats_dev.items():
            if b != ledger.get(t, 0):
                fail(f"device bytes of {t}: stats {b}, ledger "
                     f"{ledger.get(t, 0)}")
        # the storage route walks the broker's ledger; the stats service
        # lists the column tables (row tables such as nation: the ledger)
        row_dev = sum(v for t, v in ledger.items() if t not in stats_dev)
        if storage["tier"]["device_bytes"] != sum(stats_dev.values()) \
                + row_dev:
            fail(f"storage route device bytes {storage['tier']} vs the "
                 f"stats service's {sum(stats_dev.values())} and the row "
                 f"tables' {row_dev}")
        samples, typed = _prometheus_names(
            _http(svc, "/metrics/prometheus").decode())
        if len(typed) != len(set(typed)):
            fail("prometheus: a TYPE name appears twice")
        traces = _http(svc, f"/status/api/v1/traces?trace_id={q1_tid}")
        kinds = sorted(t["kind"] for t in traces["traces"])
        if "server" not in kinds or "client" not in kinds:
            fail(f"/status/api/v1/traces under {q1_tid}: {kinds}")
        log(f"front_door rest q6_s {dt:.4f} serving_hits {rest_hits} "
            f"trace_id {body['trace_id']} job_q1_s {job_s:.4f} "
            f"storage_device_bytes {storage['tier']['device_bytes']} "
            f"stats_device_bytes {sum(stats_dev.values())} "
            f"row_table_device_bytes {row_dev} lineitem "
            f"{stats_dev.get('lineitem')} prometheus samples {len(samples)} "
            f"families {len(typed)} trace {q1_tid} kinds {kinds}")

        # (f) Q6 at 1 / 4 / 16 client threads, FRONT_DOOR_REQUESTS a
        # level in process (the prepared handle) and then through Flight,
        # on the same binds
        q6_binds = [q6_bind(tpch, y, b) for y in range(1993, 1998)
                    for b in SERVING_BANDS]
        solo = {b: in_process.execute(b).rows() for b in q6_binds}
        for n in SERVING_CLIENTS:
            calls = FRONT_DOOR_REQUESTS // n
            binds = [[q6_binds[(c * calls + i) % len(q6_binds)]
                      for i in range(calls)] for c in range(n)]
            reqs = n * calls
            figures = {}
            for way, run in (
                    ("in_process",
                     lambda: serve_clients(in_process, binds, n)),
                    ("flight", lambda: flight_clients(address, binds, n))):
                torch.cuda.synchronize()
                _reset_kernel_counts()
                answers, lat, wall = run()
                torch.cuda.synchronize()
                lc = _kernel_counts()
                _launch_sum(total, lc)
                for (c, i), rows in answers.items():
                    if rows != solo[binds[c][i]]:
                        fail(f"{way} Q6 with {n} clients: bind "
                             f"{binds[c][i]} gave {rows}, solo "
                             f"{solo[binds[c][i]]}")
                if len(answers) != reqs or lc["masked_kahan_sum"] != reqs:
                    fail(f"{way} Q6 with {n} clients: {len(answers)} "
                         f"answers, launches {lc} for {reqs} requests")
                lat_ms = np.array(lat) * 1e3
                figures[way] = (
                    f"{way}_requests_per_s {reqs / wall:.1f} {way}_p50_ms "
                    f"{np.percentile(lat_ms, 50):.3f} {way}_p99_ms "
                    f"{np.percentile(lat_ms, 99):.3f}")
            log(f"front_door flight_clients {n} requests {reqs} "
                f"{figures['flight']} {figures['in_process']} launches "
                f"{json.dumps(lc)}")
    finally:
        fsql.close()
        client.close()
        svc.stop()
        srv.shutdown()
    session.sql("DROP TABLE IF EXISTS lineitem_put")
    log("answers ok: Flight, Flight SQL and REST equal session.sql; the "
        "do_put table's Q6 equals numpy")
    log(f"front_door_path_s {time.perf_counter() - t_phase:.3f}")
    return total, flight_warm


# -- phase 27: membership (locator, server and lead nodes, the CLI) --------

MEMBER_LEASE_S = 0.5          # the leads' lease: renewed every lease_s / 2
CLI_TABLE = ("CREATE TABLE cli_t USING column AS SELECT 1 AS k, 2.5 AS v "
             "UNION ALL SELECT 2, 3.5 UNION ALL SELECT 3, 4.0")
CLI_QUERY = "SELECT count(*) AS n, sum(v) AS s FROM cli_t"
CLI_ROWS = ["n | s", "--+--", "3 | 10.0", "(1 rows)"]


def _cli(root, *argv):
    """`python -m snappydata_tpu_torch *argv` from the checkout at `root`
    (stdout, stderr and the exit code are the caller's to read)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    return [sys.executable, "-m", "snappydata_tpu_torch", *argv], env


def _cli_run(root, *argv):
    cmd, env = _cli(root, *argv)
    out = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                         text=True, timeout=120)
    if out.returncode != 0:
        fail(f"python -m snappydata_tpu_torch {' '.join(argv)} exited "
             f"{out.returncode}: {out.stderr[-2000:]}")
    return out.stdout


class CliMember:
    """`n` CLI data servers: a LocatorNode in this process and `n` times
    `python -m snappydata_tpu_torch server --locator ... *extra` (no
    --device, so each session is on cuda) in processes of their own.
    Phase 27 (d) takes one, phase 28 two.  main() starts them before
    phase 25, so the processes' interpreters and CUDA contexts come up
    while phase 25 runs, and stops them after their phase whatever
    happened; each stdout is read on a thread so a startup line can be
    waited for with a deadline."""

    def __init__(self, root, device, n=1, extra=()):
        import queue
        import threading

        from snappydata_tpu_torch.cluster import LocatorNode

        self.root = root
        self.device = device
        self.locator = LocatorNode().start()
        cmd, env = _cli(root, "server", "--locator", self.locator.address,
                        *extra)
        self.t0 = time.perf_counter()
        self.procs, self.queues, self.started = [], [], []
        self._readers = []
        for i in range(n):
            self.procs.append(subprocess.Popen(
                cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
            self.queues.append(queue.Queue())
            self.started.append(None)   # seconds from the spawn to the line
            self._readers.append(threading.Thread(target=self._read,
                                                  args=(i,), daemon=True))
            self._readers[-1].start()

    @property
    def started_s(self):
        return self.started[0]

    def _read(self, i):
        from snappydata_tpu_torch import config

        with config.device_scope(self.device):
            for line in self.procs[i].stdout:
                if self.started[i] is None:
                    self.started[i] = time.perf_counter() - self.t0
                self.queues[i].put(line.rstrip("\n"))
            self.queues[i].put(None)

    def startup_line(self, timeout=300.0, i=0):
        import queue

        try:
            line = self.queues[i].get(timeout=timeout)
        except queue.Empty:
            line = None
        if line is None:
            fail(f"the CLI server printed no startup line: "
                 f"{self.procs[i].stderr.read()[-2000:]}")
        return line

    def stop(self):
        if self.locator is None:
            return
        for proc in self.procs:
            if proc.poll() is None:
                proc.terminate()
        for proc in self.procs:
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)
        for reader, proc in zip(self._readers, self.procs):
            reader.join(timeout=30)
            proc.stdout.close()
            proc.stderr.close()
        self.locator.stop()
        self.locator = None


def membership_path(session, tpch, flight_warm, cli, args):
    """Phase 27 (a) - (d) on the main session as phase 25 leaves it: a
    LocatorNode, a LeadNode and a ServerNode in this process, each over
    a session of its own on the main catalog, then `cli`, the CliMember
    main() started before phase 25.  Returns the two kernels' launches."""
    from snappydata_tpu_torch import config

    props = config.global_properties()
    props.pallas_reduce = True
    props.pallas_group_reduce = True
    t_phase = time.perf_counter()
    total = member_nodes(session, tpch, flight_warm, args)
    cli_members(cli)
    log("answers ok: Q1 / Q6 through a discovered member, after a client "
        "failover and through the new primary lead equal session.sql; the "
        "CLI's server answered its table and status listed it")
    log(f"membership_path_s {time.perf_counter() - t_phase:.3f}")
    return total


def member_nodes(session, tpch, flight_warm, args):
    """Phase 27 (a) - (c): discovery, a client failover, a lead
    failover.  Returns the two kernels' launches."""
    from snappydata_tpu_torch import SnappySession
    from snappydata_tpu_torch.cluster import (LeadNode, LocatorNode,
                                              ServerNode, SnappyClient)

    total = {"grouped_reduce": 0, "masked_kahan_sum": 0}
    locator = LocatorNode().start()
    timeout_s = locator.locator.state.timeout_s
    member = lambda: SnappySession(catalog=session.catalog)  # noqa: E731
    nodes = []
    client = None
    try:
        # (a) discovery: the server registers first, so the client that
        # asks the locator connects to it
        server = ServerNode(locator.address, member()).start()
        nodes.append(server)
        lead = LeadNode(locator.address, member(),
                        lease_s=MEMBER_LEASE_S).start(wait_for_primary=True)
        nodes.append(lead)
        if not lead.is_primary:
            fail("the lead did not become primary")
        client = SnappyClient(locator=locator.address)
        want = {"q1": session.sql(tpch.Q1).rows(),
                "q6": session.sql(tpch.Q6).rows()}
        for name, q, kernel in (("q1", tpch.Q1, "grouped_reduce"),
                                ("q6", tpch.Q6, "masked_kahan_sum")):
            times = []
            for _ in range(1 + args.reps):
                tbl, dt, lc = _served_once(lambda q=q: client.sql(q),
                                           kernel)
                _launch_sum(total, lc)
                times.append(dt)
                if _arrow_rows(tbl) != want[name]:
                    fail(f"discovered {name}: {_arrow_rows(tbl)} != "
                         f"session.sql's {want[name]}")
            if client._conn_addr != server.flight_address:
                fail(f"the client connected to {client._conn_addr}, not "
                     f"the first registered member {server.flight_address}")
            warm = sorted(times[1:])[len(times[1:]) // 2]
            log(f"membership discovered_{name} first_s {times[0]:.4f} "
                f"warm_s {warm:.4f} phase25_flight_warm_s "
                f"{flight_warm[name]:.4f} member {server.member_id} rows "
                f"{len(want[name])} equal True launches_per_run 1 {kernel}")

        # (b) client failover: the member the client talks to stops
        server.stop()
        nodes.remove(server)
        tbl, dt, lc = _served_once(lambda: client.sql(tpch.Q6),
                                   "masked_kahan_sum")
        _launch_sum(total, lc)
        if _arrow_rows(tbl) != want["q6"]:
            fail(f"Q6 after the failover: {_arrow_rows(tbl)} != "
                 f"{want['q6']}")
        if client._conn_addr != lead.flight_address:
            fail(f"the client failed over to {client._conn_addr}, not the "
                 f"live member {lead.flight_address}")
        log(f"membership client_failover q6_s {dt:.4f} from "
            f"{server.member_id} to {lead.member_id} ({lead.role}) equal "
            f"True launches 1 masked_kahan_sum")
        client.close()
        client = None

        # (c) lead failover: a second server and a standby lead join, the
        # primary stops
        server2 = ServerNode(locator.address, member()).start()
        nodes.append(server2)
        standby = LeadNode(locator.address, member(),
                           lease_s=MEMBER_LEASE_S).start()
        nodes.append(standby)
        time.sleep(MEMBER_LEASE_S)
        if standby.is_primary or not lead.is_primary:
            fail("the standby took the lock from a live primary")
        live = {server2.member_id, standby.member_id}
        t0 = time.perf_counter()
        lead.stop()
        nodes.remove(lead)
        stop_s = time.perf_counter() - t0
        listed = set()
        while time.perf_counter() - t0 < 30:
            rest = standby.rest
            if standby.is_primary and rest is not None:
                body = _http(rest, "/status/api/v1/cluster")
                listed = {m["member_id"] for m in body["members"]}
                if listed == live:
                    break
            time.sleep(0.005)
        failover_s = time.perf_counter() - t0
        if listed != live:
            fail(f"after the primary stopped the standby lead is primary "
                 f"{standby.is_primary}, its cluster route lists {listed}, "
                 f"not {live}")
        direct = SnappyClient(address=standby.flight_address)
        try:
            tbl, dt, lc = _served_once(lambda: direct.sql(tpch.Q1),
                                       "grouped_reduce")
        finally:
            direct.close()
        _launch_sum(total, lc)
        if _arrow_rows(tbl) != want["q1"]:
            fail(f"Q1 through the new primary: {_arrow_rows(tbl)} != "
                 f"{want['q1']}")
        log(f"membership lead_failover s {failover_s:.4f} primary_stop_s "
            f"{stop_s:.4f} lease_s {MEMBER_LEASE_S} member_timeout_s "
            f"{timeout_s} new_primary {standby.member_id} cluster_members "
            f"{sorted(listed)} q1_s {dt:.4f} equal True launches 1 "
            f"grouped_reduce")
    finally:
        if client is not None:
            client.close()
        for node in reversed(nodes):
            node.stop()
        locator.stop()
    return total


def cli_members(cli):
    """Phase 27 (d): the CliMember's server, a table made and read through
    `sql --locator -e`, `status`."""
    import re
    import threading

    from snappydata_tpu_torch import config

    root, locator = cli.root, cli.locator.address
    t0 = time.perf_counter()
    line = cli.startup_line()
    wait_s = time.perf_counter() - t0
    m = re.fullmatch(r"server (server-[0-9a-f]{8}) flight at "
                     r"(127\.0\.0\.1:\d+)", line)
    if not m:
        fail(f"the CLI server's startup line: {line!r}")
    t0 = time.perf_counter()
    created = _cli_run(root, "sql", "--locator", locator, "-e", CLI_TABLE)
    create_s = time.perf_counter() - t0
    both = {}

    def run(key, *argv):
        with config.device_scope(cli.device):
            both[key] = _cli_run(root, *argv)

    t0 = time.perf_counter()
    ts = [threading.Thread(target=run, args=a) for a in (
        ("query", "sql", "--locator", locator, "-e", CLI_QUERY),
        ("status", "status", "--locator", locator))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=300)
    query_s = time.perf_counter() - t0
    if set(both) != {"query", "status"}:
        fail(f"the CLI's query and status did not both end: {sorted(both)}")
    if both["query"].splitlines() != CLI_ROWS:
        fail(f"sql -e {CLI_QUERY!r} printed {both['query']!r}")
    status = both["status"].splitlines()
    if status != [f"server   {m.group(1):24s} {m.group(2)}",
                  "(1 members)"]:
        fail(f"status printed {status}")
    log(f"membership cli server {m.group(1)} startup_s {cli.started_s:.2f} "
        f"startup_wait_s {wait_s:.2f} create_s {create_s:.2f} query_and_status_s {query_s:.2f} created "
        f"{created.strip()} rows {both['query'].splitlines()[2]!r} status "
        f"{status[0]!r}")


# -- phase 28: the distributed session -------------------------------------

DIST_SERVERS = 2              # data-server processes, both on the one card
DIST_DEPTH = 8                # phase 28 routes 1 / DIST_DEPTH of lineitem
DIST_SCAN = ("SELECT l_orderkey, l_quantity, l_extendedprice FROM lineitem "
             "WHERE l_quantity >= 50 AND l_discount >= 0.1")
DIST_UPDATE_KEYS = 240_000    # the fanned-out UPDATE takes orders 1 .. this
DIST_UPDATE = ("UPDATE lineitem SET l_discount = 0.06 WHERE l_orderkey <= "
               f"{DIST_UPDATE_KEYS}")
DIST_PROBE = "SELECT count(*) AS n FROM lineitem"  # reads the counts


def _server_kernels(ds, sql):
    """`EXPLAIN ANALYZE sql` on each server over Flight.  Its `kernels`
    line is counted in the server's process: the session's device, the
    plate bytes of the query's tables resident there, and for each CUDA
    kernel the launches of this pass and the wrapper's count so far.
    Returns one (device, resident_bytes, {kernel: (pass, total)}) a
    server."""
    out = []
    for srv in ds.servers:
        rows = [(line,) for line in
                srv.sql("EXPLAIN ANALYZE " + sql).column(0).to_pylist()]
        line = next((r[0] for r in rows if r[0].startswith("kernels ")),
                    None)
        if line is None:
            fail(f"EXPLAIN ANALYZE printed no kernels line: {rows}")
        fields = dict(tok.split("=", 1) for tok in line.split()[1:])
        device = fields.pop("device")
        resident = int(fields.pop("resident_bytes"))
        out.append((device, resident, {
            k: tuple(int(x) for x in v.split("/"))
            for k, v in fields.items()}))
    return out


def _timed_launches(before, after, kernel):
    """Launches of `kernel` on each server between the `_server_kernels`
    readings `before` and `after`, the EXPLAIN ANALYZE pass of `after`
    left out."""
    return [a[2][kernel][1] - a[2][kernel][0] - b[2][kernel][1]
            for b, a in zip(before, after)]


class DistLoad:
    """Phase 28 (a), started at the top of phase 17: a DistributedSession
    on the card in this process over `members`' two data servers, the
    kernel knobs turned on in each server, then on a thread of its own
    the routed ingest of the first 1 / DIST_DEPTH of lineitem and the
    numpy oracle of Q1 / Q6 over those rows.  Phase 17 waits on its child
    process and the servers encode on their own cores, so the ingest's
    host work runs beside it; phase 28 waits for the thread."""

    def __init__(self, members, li, tpch):
        import re
        import threading

        from snappydata_tpu_torch.cluster.distributed import \
            DistributedSession

        self.waits = []
        for i in range(len(members.procs)):
            t0 = time.perf_counter()
            line = members.startup_line(i=i)
            self.waits.append(time.perf_counter() - t0)
            if not re.fullmatch(r"server (server-[0-9a-f]{8}) flight at "
                                r"(127\.0\.0\.1:\d+)", line):
                fail(f"a data server's startup line: {line!r}")
        self.ds = DistributedSession(locator=members.locator.address)
        if len(self.ds.servers) != DIST_SERVERS or \
                self.ds.device.type != "cuda":
            fail(f"the lead found {self.ds.server_addresses} on "
                 f"{self.ds.device}")
        for srv in self.ds.servers:
            for knob in ("pallas_reduce", "pallas_group_reduce"):
                srv.execute(f"SET {knob} = true")
        self.n = len(li["l_orderkey"]) // DIST_DEPTH
        self.cols = {k: v[:self.n] for k, v in li.items()}
        self.ds.sql(tpch.LINEITEM_DDL)
        self.error = None
        self._thread = threading.Thread(target=self._load, args=(tpch,),
                                        daemon=True)
        self._thread.start()

    def _load(self, tpch):
        from snappydata_tpu_torch import config

        try:
            with config.device_scope(self.ds.device):
                t0 = time.perf_counter()
                self.ds.insert_arrays("lineitem", list(self.cols.values()))
                self.ingest_s = time.perf_counter() - t0
                self.want = oracle(self.cols, tpch)
        except Exception as e:  # noqa: BLE001 - phase 28 reports it
            self.error = e

    def wait(self):
        """Seconds phase 28 waited for the ingest and the oracle."""
        t0 = time.perf_counter()
        self._thread.join()
        if self.error is not None:
            fail(f"the routed ingest: {type(self.error).__name__}: "
                 f"{self.error}")
        return time.perf_counter() - t0


def distributed_path(load, tpch, in_process_warm, members, args):
    """Phase 28 (b) - (e) over `load` (DistLoad): Q1 / Q6 scattered and
    merged, a filtered scan concatenated, a fanned-out UPDATE and Q6
    again, each against numpy; every server's partials through both
    kernels; no gather downgrade."""
    import numpy as np

    from snappydata_tpu_torch.observability.metrics import global_registry

    t_phase = time.perf_counter()
    ds, cols, n = load.ds, load.cols, load.n
    wait_s = load.wait()
    counts = [int(srv.sql("SELECT count(*) AS n FROM lineitem")
                  .column(0)[0].as_py()) for srv in ds.servers]
    if sum(counts) != n or min(counts) == 0:
        fail(f"the servers hold {counts} rows, not {n} in all")
    log(f"distributed ingest rows {n} s {load.ingest_s:.3f} rows_per_s "
        f"{n / load.ingest_s:.0f} (beside phase 17) phase28_wait_s "
        f"{wait_s:.3f} per_server {counts} servers {ds.server_addresses} "
        f"startup_s {[round(x, 2) for x in members.started]} "
        f"startup_wait_s {[round(x, 2) for x in load.waits]}")
    reg = global_registry()
    down0 = reg.counters_snapshot().get("dist_downgrades", 0)
    fan_s = [0.0]
    fan = ds._fan

    def timed_fan(*a, **kw):
        t0 = time.perf_counter()
        try:
            return fan(*a, **kw)
        finally:
            fan_s[0] += time.perf_counter() - t0

    ds._fan = timed_fan
    frags = []
    partial_exec = ds._partial_exec

    def recorded(node):
        frags.append(node)
        return partial_exec(node)

    ds._partial_exec = recorded
    try:
        # (b) Q1 / Q6 scattered and merged: first, warm, the merge apart
        # from the fan-out; each server's launches of the query's kernel
        # over these timed runs, counted in its process
        from snappydata_tpu_torch.sql.render import render_plan

        before = _server_kernels(ds, DIST_PROBE)
        for q, kernel in (("q1", "grouped_reduce"),
                          ("q6", "masked_kahan_sum")):
            times, merges = [], []
            for _ in range(1 + args.reps):
                fan_s[0] = 0.0
                t0 = time.perf_counter()
                rows = ds.sql(getattr(tpch, q.upper())).rows()
                dt = time.perf_counter() - t0
                times.append(dt)
                merges.append(dt - fan_s[0])
                check_rows(f"distributed {q}", rows, load.want[q])
            read = _server_kernels(ds, render_plan(frags[-1]))
            timed = _timed_launches(before, read, kernel)
            own = [a[2][kernel][0] for a in read]
            if any(t < len(times) for t in timed) or min(own) < 1:
                fail(f"distributed {q}: the servers launched {kernel} "
                     f"{timed} times in {len(times)} runs ({own} a "
                     f"fragment)")
            if any(not a[0].startswith("cuda") or a[1] <= 0
                   for a in read):
                fail(f"distributed {q}: the servers' plates are on "
                     f"{[(a[0], a[1]) for a in read]}")
            warm = _median(times[1:])
            log(f"distributed {q} first_s {times[0]:.4f} warm_s {warm:.4f} "
                f"merge_s {_median(merges[1:]):.4f} fan_out_s "
                f"{warm - _median(merges[1:]):.4f} phase4_warm_s "
                f"{in_process_warm[q]:.4f} rows {len(rows)} oracle ok "
                f"runs {len(times)} server_{kernel}_launches {timed} "
                f"a_fragment {own} server_device "
                f"{[a[0] for a in read]} server_resident_bytes "
                f"{[a[1] for a in read]}")
            before = read

        # (c) a filtered scan, concatenated
        t0 = time.perf_counter()
        got = ds.sql(DIST_SCAN).num_rows
        scan_s = time.perf_counter() - t0
        exp = int(((cols["l_quantity"] >= 50)
                   & (cols["l_discount"] >= 0.1)).sum())
        if got != exp:
            fail(f"distributed scan: {got} rows, numpy {exp}")
        log(f"distributed scan rows {got} s {scan_s:.4f} equal True")

        # (d) a fanned-out UPDATE, then Q6 again
        hit = cols["l_orderkey"] <= DIST_UPDATE_KEYS
        t0 = time.perf_counter()
        upd = int(ds.sql(DIST_UPDATE).rows()[0][0])
        upd_s = time.perf_counter() - t0
        if upd != int(hit.sum()):
            fail(f"distributed UPDATE touched {upd} rows, numpy "
                 f"{int(hit.sum())}")
        after = dict(cols)
        after["l_discount"] = np.where(hit, 0.06, cols["l_discount"])
        before = _server_kernels(ds, DIST_PROBE)
        t0 = time.perf_counter()
        rows = ds.sql(tpch.Q6).rows()
        q6_s = time.perf_counter() - t0
        check_rows("distributed q6 after the UPDATE", rows,
                   q6_oracle(after, tpch))
        timed = _timed_launches(
            before, _server_kernels(ds, render_plan(frags[-1])),
            "masked_kahan_sum")
        if min(timed) < 1:
            fail(f"Q6 after the UPDATE launched masked_kahan_sum {timed} "
                 f"times on the servers")
        log(f"distributed update rows {upd} s {upd_s:.3f} q6_after_s "
            f"{q6_s:.4f} oracle ok server_masked_kahan_sum_launches "
            f"{timed}")

        # (e) each server's table through its Flight stats action (rows
        # and the column batches' bytes; the device bytes are the kernels
        # line's above)
        for i, srv in enumerate(ds.servers):
            st = srv.stats().get("lineitem", {})
            log(f"distributed server {ds.server_addresses[i]} rows "
                f"{st.get('row_count')} in_memory_bytes "
                f"{st.get('in_memory_bytes')}")
        down = reg.counters_snapshot().get("dist_downgrades", 0) - down0
        if down or ds.last_downgrades:
            fail(f"phase 28 downgraded to a gather: {ds.last_downgrades}")
    finally:
        ds.close()
    log("answers ok: the routed rows add up; Q1 / Q6 scattered over two "
        "server processes, a concatenated scan and Q6 after a fanned-out "
        "UPDATE equal numpy; each server launched the grouped and Kahan "
        "kernels on its card in every timed run; no gather downgrade")
    log(f"distributed_path_s {time.perf_counter() - t_phase:.3f}")


# -- phase 26: streams ----------------------------------------------------

STREAM_ROWS = 1 << 22         # rows a memory stream takes (reduced, SF 16)
STREAM_BATCH = 1 << 17        # rows a micro-batch
KAFKA_RECORDS = 20_000        # keyed records through a file broker
MV_BATCHES = 8                # keyless micro-batches under q1_mv


def _lineitem_columns(tpch):
    return tpch.LINEITEM_DDL.split("(", 1)[1].split(") USING")[0]


def _wait_for(what, cond, timeout=120.0, poll_s=0.002):
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        if cond():
            return
        time.sleep(poll_s)
    fail(f"{what}: timed out after {timeout} s")


def stream_path(tpch, li, args):
    """Phase 26 on a session of its own: a memory stream of lineitem's
    first STREAM_ROWS rows in micro-batches of STREAM_BATCH, Q1 / Q6 and
    a windowed Q6 over it; a keyed kafka_stream over a file broker,
    stopped and restarted midway; a materialized Q1 over a keyless
    stream.  Returns the two kernels' launches."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from snappydata_tpu_torch import SnappySession, config
    from snappydata_tpu_torch.catalog import Catalog
    from snappydata_tpu_torch.observability.metrics import global_registry
    from snappydata_tpu_torch.streaming.kafka import FileBroker

    props = config.global_properties()
    props.pallas_reduce = True
    props.pallas_group_reduce = True
    reg = global_registry()
    total = {"grouped_reduce": 0, "masked_kahan_sum": 0}
    t_phase = time.perf_counter()
    s = SnappySession(catalog=Catalog())   # device: cuda
    tmp = tempfile.mkdtemp(prefix="chip_smoke_stream_")
    try:
        # (a) a memory stream of lineitem's first rows
        s.sql(f"CREATE STREAM TABLE ls ({_lineitem_columns(tpch)}) "
              "USING memory_stream OPTIONS (interval '0.002')")
        q = s.catalog._streams["ls"]
        applied = []
        real = q.sink.process_batch

        def timed(batch_id, columns):
            t0 = time.perf_counter()
            out = real(batch_id, columns)
            stamp = columns["__arrival_ts"]
            applied.append((time.perf_counter() - t0, time.perf_counter(),
                            int(stamp[0]), len(stamp)))
            return out

        q.sink.process_batch = timed
        src = s.stream_source("ls")
        part = {k: v[:STREAM_ROWS] for k, v in li.items()}
        t0 = time.perf_counter()
        for lo in range(0, STREAM_ROWS, STREAM_BATCH):
            src.add_batch({k: v[lo:lo + STREAM_BATCH]
                           for k, v in part.items()})
        n_batches = STREAM_ROWS // STREAM_BATCH
        _wait_for("the memory stream", lambda: len(applied) >= n_batches)
        ingest_s = applied[-1][1] - t0
        if q.rows_processed != STREAM_ROWS or q.last_error is not None:
            fail(f"memory stream: {q.rows_processed} rows, last error "
                 f"{q.last_error}")
        per = np.array([a[0] for a in applied]) * 1e3
        log(f"stream ingest rows {STREAM_ROWS} batches {n_batches} s "
            f"{ingest_s:.3f} rows_per_s {STREAM_ROWS / ingest_s:.0f} "
            f"batch_p50_ms {np.percentile(per, 50):.2f} batch_p99_ms "
            f"{np.percentile(per, 99):.2f}")
        want = oracle(part, tpch)
        sq1, sq6 = (tpch.Q1.replace("lineitem", "ls"),
                    tpch.Q6.replace("lineitem", "ls"))
        # the window's cutoff falls midway between the arrival stamps of
        # micro-batches j - 1 and j: it holds batch j on and no earlier row
        j = n_batches // 2
        stamps = [a[2] for a in applied]
        if stamps != sorted(stamps) or stamps[j] <= stamps[j - 1]:
            fail(f"memory stream: arrival stamps not increasing: {stamps}")
        cut_us = (stamps[j - 1] + stamps[j]) / 2
        slack_s = (stamps[j] - stamps[j - 1]) / 2e6
        win_lo = sum(a[3] for a in applied[:j])
        want_win = oracle({k: v[win_lo:] for k, v in part.items()}, tpch)

        def window_q6():
            t0 = time.time()
            dur_ms = (t0 * 1e6 - cut_us) / 1e3
            rows = s.sql(sq6.replace(
                "FROM ls", f"FROM ls WINDOW (DURATION {dur_ms:.3f} "
                "MILLISECONDS)")).rows()
            if time.time() - t0 >= slack_s:
                fail(f"a windowed Q6 took over {slack_s:.3f} s: its cutoff "
                     "may have passed a micro-batch's stamp")
            return rows

        for name, run, kernel, ref in (
                ("q1", lambda: s.sql(sq1).rows(), "grouped_reduce",
                 want["q1"]),
                ("q6", lambda: s.sql(sq6).rows(), "masked_kahan_sum",
                 want["q6"]),
                ("window_q6", window_q6, "masked_kahan_sum",
                 want_win["q6"])):
            times = []
            for _ in range(1 + args.reps):
                rows, dt, lc = _served_once(run, kernel)
                _launch_sum(total, lc)
                times.append(dt)
            check_rows(f"stream {name}", rows, ref)
            log(f"stream {name} first_s {times[0]:.4f} warm_s "
                f"{sorted(times[1:])[len(times[1:]) // 2]:.4f} "
                f"equal_numpy True launches_per_run 1 {kernel}")
        if want_win["q6"] == want["q6"]:
            fail("the window's half of the stream gave the whole stream's Q6")
        log(f"stream window rows {STREAM_ROWS - win_lo} of {STREAM_ROWS} "
            f"batches {n_batches - j} of {n_batches} cutoff_slack_s "
            f"{slack_s:.4f}")
        misses = reg.counter("plan_cache_misses")
        window_q6()
        if reg.counter("plan_cache_misses") != misses:
            fail("a warm windowed Q6 missed the plan cache")
        s.sql("DROP TABLE ls")
        del part

        # (b) a keyed kafka_stream over a file broker, stopped and
        # restarted midway: every published row once
        bdir = os.path.join(tmp, "broker")
        producer = FileBroker(bdir, num_partitions=4)
        ddl = ("CREATE STREAM TABLE ks (id BIGINT, v DOUBLE) USING "
               f"kafka_stream OPTIONS (topic 'ev', brokers 'file://{bdir}', "
               "key_columns 'id', interval '0.005', "
               "maxRecordsPerBatch '2000')")
        half = KAFKA_RECORDS // 2
        t0 = time.perf_counter()
        producer.produce("ev", [{"id": i, "v": float(i)}
                                for i in range(half)])
        s.sql(ddl)
        first = s.catalog._streams["ks"]
        _wait_for("the kafka stream's first batches",
                  lambda: first.rows_processed >= 2000)
        s.catalog._streams.pop("ks").stop()
        before_restart = s.sql("SELECT count(*) FROM ks").rows()[0][0]
        producer.produce("ev", [{"id": i, "v": float(i)}
                                for i in range(half, KAFKA_RECORDS)])
        s.sql(ddl)                       # the query restarts from its log
        _wait_for("the restarted kafka stream", lambda: s.sql(
            "SELECT count(*) FROM ks").rows()[0][0] >= KAFKA_RECORDS,
            poll_s=0.05)
        kafka_s = time.perf_counter() - t0
        cnt, dcnt, sv = s.sql("SELECT count(*), count(DISTINCT id), sum(v) "
                              "FROM ks").rows()[0]
        expect = float(KAFKA_RECORDS * (KAFKA_RECORDS - 1) // 2)
        if (cnt, dcnt) != (KAFKA_RECORDS, KAFKA_RECORDS) \
                or abs(sv - expect) > 1e-6 * expect:
            fail(f"kafka stream after a restart: {cnt} rows, {dcnt} ids, "
                 f"sum {sv}, expected {KAFKA_RECORDS} once each")
        log(f"stream kafka records {KAFKA_RECORDS} stopped_at "
            f"{before_restart} s {kafka_s:.3f} rows {cnt} distinct {dcnt} "
            f"once_each True")
        s.sql("DROP TABLE ks")

        # (c) q1_mv over a keyless stream folds once per micro-batch and
        # equals its full refresh
        s.sql("CREATE STREAM TABLE lk (l_returnflag STRING, l_linestatus "
              "STRING, l_quantity DOUBLE, l_extendedprice DOUBLE, "
              "l_discount DOUBLE) USING memory_stream "
              "OPTIONS (interval '0.002')")
        mv_sql = ("SELECT l_returnflag, l_linestatus, sum(l_quantity) AS sq, "
                  "sum(l_extendedprice) AS sp, "
                  "sum(l_extendedprice * (1 - l_discount)) AS sd, "
                  "count(*) AS c FROM lk GROUP BY l_returnflag, "
                  "l_linestatus")
        s.sql("CREATE MATERIALIZED VIEW q1_mv AS " + mv_sql)
        lq = s.catalog._streams["lk"]
        folds0 = reg.counter("view_delta_folds")
        full0 = reg.counter("view_full_refreshes")
        src = s.stream_source("lk")
        lo0 = STREAM_ROWS
        cols = ("l_returnflag", "l_linestatus", "l_quantity",
                "l_extendedprice", "l_discount")
        for i in range(MV_BATCHES):
            lo = lo0 + i * STREAM_BATCH
            src.add_batch({k: li[k][lo:lo + STREAM_BATCH] for k in cols})
        _wait_for("the keyless stream",
                  lambda: lq.rows_processed >= MV_BATCHES * STREAM_BATCH)
        folds = reg.counter("view_delta_folds") - folds0
        order = " ORDER BY l_returnflag, l_linestatus"
        _reset_kernel_counts()
        view = s.sql("SELECT * FROM q1_mv" + order).rows()
        full = s.sql(mv_sql + order).rows()
        torch.cuda.synchronize()
        _launch_sum(total, _kernel_counts())
        if folds != MV_BATCHES or reg.counter("view_full_refreshes") != full0:
            fail(f"q1_mv over the stream: {folds} folds for {MV_BATCHES} "
                 f"micro-batches, full refreshes "
                 f"{reg.counter('view_full_refreshes') - full0}")
        check_rows("q1_mv against its full refresh", view, full)
        log(f"stream q1_mv batches {MV_BATCHES} rows "
            f"{MV_BATCHES * STREAM_BATCH} folds {folds} full_refreshes 0 "
            f"equal_full_refresh True")
        s.sql("DROP MATERIALIZED VIEW q1_mv")
        s.sql("DROP TABLE lk")
    finally:
        for sq in list(getattr(s.catalog, "_streams", {}).values()):
            sq.stop()
        s.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    log("answers ok: stream Q1 / Q6 and the window equal numpy; the keyed "
        "restart lost and duplicated nothing; q1_mv equals its refresh")
    log(f"stream_path_s {time.perf_counter() - t_phase:.3f}")
    return total


def routed_strings_main(tpch, n, seed):
    """--routed-strings: the string columns of phase 28's routed insert
    (lineitem, `n` rows), each built as the Arrow array the insert sends
    twice: in Arrow in one call (`_string_array`, what the port runs) and
    by the reference's per-row `str(v)` loop.  The lead builds a server's
    piece before sending it, so the difference adds to the ingest's
    seconds one for one.  Fails if the two arrays differ."""
    import pyarrow as pa

    from snappydata_tpu_torch.cluster.distributed import _string_array

    li = tpch.gen_lineitem(n, seed)
    out = {"rows": n}
    for name, vals in li.items():
        if vals.dtype != object:
            continue
        t0 = time.perf_counter()
        fast = _string_array(vals, None)
        arrow_s = time.perf_counter() - t0
        mask = None
        t0 = time.perf_counter()
        loop = pa.array([None if (mask is not None and mask[j])
                         or v is None else str(v)
                         for j, v in enumerate(vals)], type=pa.string())
        loop_s = time.perf_counter() - t0
        if not fast.equals(loop):
            fail(f"routed strings: {name} differs from the loop's array")
        out[name] = {"arrow_s": round(arrow_s, 3),
                     "loop_s": round(loop_s, 3)}
    log(f"routed_strings {json.dumps(out)}")
    return 0


class PhaseClock:
    """Logs each phase's wall seconds (`phase_s <n> <s>`) when the next
    one starts, so a run's time budget reads per phase, and their total
    (`phase_total_s`) when the last one ends (`next(None)`)."""

    def __init__(self):
        self.phase = None
        self.t0 = time.perf_counter()
        self.total = 0.0

    def next(self, phase) -> None:
        now = time.perf_counter()
        if self.phase is not None:
            log(f"phase_s {self.phase} {now - self.t0:.1f}")
            self.total += now - self.t0
        if phase is None:
            log(f"phase_total_s {self.total:.1f}")
        self.phase, self.t0 = phase, now


def load_only_main(tpch, n_rows, seed, root):
    """--load-only: phase 3's generation and timed `insert_arrays` of
    lineitem alone, through the package under `root` (string columns
    through its native encoder where it has one)."""
    import importlib

    from snappydata_tpu_torch import SnappySession, config
    from snappydata_tpu_torch.catalog import Catalog

    try:
        native = importlib.import_module("snappydata_tpu_torch.native")
        encoder = "native" if native.native_available() else "plain"
    except ImportError:
        native, encoder = None, "plain (no native module)"
    t0 = time.perf_counter()
    li = tpch.gen_lineitem(n_rows, seed)
    gen_s = time.perf_counter() - t0
    config.global_properties().compaction_enabled = False
    session = SnappySession(catalog=Catalog())
    session.sql(tpch.LINEITEM_DDL)
    t0 = time.perf_counter()
    session.insert_arrays("lineitem", list(li.values()))
    load_s = time.perf_counter() - t0
    fallbacks = native.counters()["native_fallbacks"] if native else None
    log(f"load_only tree {root} encoder {encoder} native_fallbacks "
        f"{fallbacks} gen_s {gen_s:.3f} rows {n_rows} load_s {load_s:.3f} "
        f"rows_per_s {n_rows / load_s:.0f}")
    session.stop()
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=16.0,
                    help="TPC-H scale factor of lineitem (6M rows each)")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--profile", action="store_true",
                    help="also trace one warm run of each timed query "
                         "with torch.profiler")
    ap.add_argument("--ptxas", action="store_true",
                    help="build with -Xptxas -v and print each kernel's "
                         "registers, shared memory and spills")
    ap.add_argument("--trace-dir", metavar="DIR",
                    help="with --profile, write each trace that lost kernel "
                         "records to DIR as a Chrome trace")
    ap.add_argument("--kahan-profile", metavar="PATH",
                    help="child mode of phase 17: profile the Kahan kernel "
                         "on the inputs saved in PATH")
    ap.add_argument("--tpcds-sf", type=float, default=TPCDS_SF,
                    help="phase 30's TPC-DS scale factor (store_sales "
                         "2,880,000 rows each)")
    ap.add_argument("--tpcds-only", action="store_true",
                    help="run phases 1, 2 and 30 alone, on a session of "
                         "their own, and print no result line")
    ap.add_argument("--load-only", action="store_true",
                    help="only generate lineitem at --sf and time its "
                         "load (phase 3's insert) on a session of its own; "
                         "no result line")
    ap.add_argument("--tree", metavar="DIR",
                    help="import snappydata_tpu_torch from DIR instead of "
                         "beside this script (with --load-only: another "
                         "checkout's load, timed the same way)")
    ap.add_argument("--routed-strings", action="store_true",
                    help="only time the string columns of phase 28's "
                         "routed insert both ways (routed_strings_main)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    if args.kahan_profile:
        return kahan_profile_main(args.kahan_profile, args.reps)
    if args.trace_dir:
        TRACE_DIR.append(os.path.abspath(args.trace_dir))
    root = os.path.abspath(args.tree) if args.tree \
        else os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        from snappydata_tpu_torch import SnappySession, config
        from snappydata_tpu_torch.catalog import Catalog
        from snappydata_tpu_torch.engine import executor
        from snappydata_tpu_torch.observability.metrics import \
            global_registry
        from snappydata_tpu_torch.ops import cuda_build
        from snappydata_tpu_torch.ops import group_reduce as gr
        from snappydata_tpu_torch.ops import kahan_reduce as kr
        from snappydata_tpu_torch.utils import tpch
        from snappydata_tpu_torch.utils import tpch_code_domain as tcd
    except ImportError as e:
        fail(f"the snappydata_tpu_torch package is not beside this script "
             f"({e})")
    if "jax" in sys.modules or any(m.startswith("snappydata_tpu.")
                                   for m in sys.modules):
        fail("the port imported JAX or the JAX package")
    if args.load_only:
        return load_only_main(tpch, int(args.sf * ROWS_PER_SF), args.seed,
                              root)
    if args.routed_strings:
        return routed_strings_main(
            tpch, int(args.sf * ROWS_PER_SF) // DIST_DEPTH, args.seed)

    phase_clock = PhaseClock()
    # 1. the card
    phase_clock.next(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    kind = torch.cuda.get_device_name(0)

    # 2. build: the nvcc processes run on while phase 3 generates and
    # loads lineitem (nothing launches a kernel before phase 4)
    phase_clock.next(2)
    t_build = time.perf_counter()
    ptxas = ("-Xptxas", "-v") if args.ptxas else ()
    pending = cuda_build.start_build(KERNELS, force=True, extra_flags=ptxas)

    def build_done(after):
        t0 = time.perf_counter()
        try:
            built = pending.wait()
        except RuntimeError as e:
            fail(str(e))
        log(f"build_s {time.perf_counter() - t_build:.3f} "
            f"({', '.join(KERNELS)}; waited {time.perf_counter() - t0:.3f} "
            f"s after {after})")
        if args.ptxas:
            for name in built:
                for line in built[name].splitlines():
                    if "ptxas" in line or "spill" in line:
                        log(f"ptxas {name}: {line.strip()}")

    from snappydata_tpu_torch import native

    t0 = time.perf_counter()
    if not native.native_available():
        fail("the native string encoder did not build with g++")
    log(f"native_build_s {time.perf_counter() - t0:.3f} ({native.SO})")
    if args.tpcds_only:
        build_done("the native build")
        props = config.global_properties()
        props.compaction_enabled = False
        props.join_expand_max_bytes = 8 << 30   # as phase 10 leaves them
        props.join_build_cache_bytes = 8 << 30
        phase_clock.next(30)
        try:
            tpcds_path(SnappySession(catalog=Catalog()), args)
        except Exception as e:  # noqa: BLE001 - report the phase, then exit
            fail(f"TPC-DS path: {type(e).__name__}: {e}")
        phase_clock.next(None)
        return 0

    # 3. data
    phase_clock.next(3)
    n_rows = int(args.sf * ROWS_PER_SF)
    t0 = time.perf_counter()
    li = tpch.gen_lineitem(n_rows, args.seed)
    log(f"gen_s {time.perf_counter() - t0:.3f} rows {n_rows}")
    props = config.global_properties()
    # the broker-kicked compactor would fold the mutated tables between
    # the timed phases: it stays off until phase 20 (h) drives its sweep
    props.compaction_enabled = False
    session = SnappySession(catalog=Catalog())   # device: cuda
    session.sql(tpch.LINEITEM_DDL)
    t0 = time.perf_counter()
    session.insert_arrays("lineitem", list(li.values()))
    load_s = time.perf_counter() - t0
    log(f"load_s {load_s:.3f} rows_per_s {n_rows / load_s:.0f} "
        f"native_fallbacks {native.counters()['native_fallbacks']}")
    build_done("the load")

    # 4. the main path, kernel lanes on
    phase_clock.next(4)
    props.pallas_reduce = True
    props.pallas_group_reduce = True
    # the executor's references to the two wrappers record the inputs
    # the main path hands each kernel; the wrappers count their launches
    rec_k = Recorder(executor.masked_kahan_sum)
    rec_g = Recorder(executor.grouped_reduce)
    executor.masked_kahan_sum = rec_k
    executor.grouped_reduce = rec_g
    kr.masked_kahan_sum.launches = 0
    gr.grouped_reduce.launches = 0
    try:
        first = run_queries(session, tpch)
    except Exception as e:  # noqa: BLE001 - report the phase, then exit
        fail(f"main path: {type(e).__name__}: {e}")
    launches = {"masked_kahan_sum": kr.masked_kahan_sum.launches,
                "grouped_reduce": gr.grouped_reduce.launches}
    executor.masked_kahan_sum = rec_k.fn
    executor.grouped_reduce = rec_g.fn
    log(f"main_path_launches {json.dumps(launches)}")
    for name, count in launches.items():
        if count < 1:
            fail(f"{name} did not launch on the main path")
    for q, (rows, s) in first.items():
        log(f"{q}_first_s {s:.3f}")
    warm = {}
    for q in ("q1", "q6"):
        times = []
        for _ in range(args.reps):
            times.append(run_queries(session, tpch)[q][1])
        warm[q] = sorted(times)[len(times) // 2]
        log(f"{q}_warm_s {warm[q]:.4f} rows_per_s {n_rows / warm[q]:.0f}")
    if args.profile:
        for q in ("q1", "q6"):
            log(f"profile {q} " + json.dumps(profile_run(
                lambda q=q: session.sql(getattr(tpch, q.upper())).rows())))

    # 5. kernels against their plain versions, on the main path's inputs
    phase_clock.next(5)
    kres = {"masked_kahan_sum": kahan_phase(rec_k.calls, args.reps),
            "grouped_reduce": grouped_phase(rec_g.calls, args.reps)}
    for name, r in kres.items():
        log(f"kernel {name} " + json.dumps(r))

    # 6. the answers
    phase_clock.next(6)
    # the string compares over lineitem's two flag columns run once here;
    # phase 16's oracles read the codes
    li_code = flag_status_code(li["l_returnflag"], li["l_linestatus"])
    want = oracle(li, tpch, li_code)
    for q in ("q1", "q6"):
        check_rows(f"{q} vs numpy oracle", first[q][0], want[q])
    props.pallas_reduce = False
    props.pallas_group_reduce = False
    off = run_queries(session, tpch)
    for q in ("q1", "q6"):
        check_rows(f"{q} vs knobs off", first[q][0], off[q][0])
        log(f"{q}_knobs_off_s {off[q][1]:.4f}")
    log("answers ok: Q1 (%d groups) and Q6 match the oracle and the "
        "knobs-off lanes" % len(first["q1"][0]))

    # 7. the compressed-domain path: Q6 / Q1 over code plates
    phase_clock.next(7)
    data = session.catalog.lookup_table("lineitem").data
    if data.snapshot().row_count:
        data.force_rollover()   # row-buffer rows would bind decoded
    rec_f = Recorder(tcd.fused_code_filter_sum)
    rec_c = Recorder(tcd.grouped_code_reduce)
    tcd.fused_code_filter_sum = rec_f
    tcd.grouped_code_reduce = rec_c
    kr.fused_code_filter_sum.launches = 0
    gr.grouped_code_reduce.launches = 0
    try:
        t0 = time.perf_counter()
        q6_out = tcd.code_domain_q6(session)
        t6 = time.perf_counter() - t0
        t0 = time.perf_counter()
        q1_out = tcd.code_domain_q1(session)
        t1 = time.perf_counter() - t0
    except Exception as e:  # noqa: BLE001 - report the phase, then exit
        fail(f"compressed-domain path: {type(e).__name__}: {e}")
    code_launches = {
        "fused_code_filter_sum": kr.fused_code_filter_sum.launches,
        "grouped_code_reduce": gr.grouped_code_reduce.launches}
    tcd.fused_code_filter_sum = rec_f.fn
    tcd.grouped_code_reduce = rec_c.fn
    log(f"code_domain_launches {json.dumps(code_launches)}")
    for name, count in code_launches.items():
        if count < 1:
            fail(f"{name} did not launch on the compressed-domain path")
    launches.update(code_launches)
    log(f"code_domain_q6 {json.dumps(q6_out)}")
    log(f"code_domain_q1 {json.dumps(q1_out)}")
    for name, fn, t_first in (("code_domain_q6", tcd.code_domain_q6, t6),
                              ("code_domain_q1", tcd.code_domain_q1, t1)):
        times = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            fn(session)
            times.append(time.perf_counter() - t0)
        log(f"{name}_first_s {t_first:.4f} warm_s "
            f"{sorted(times)[len(times) // 2]:.4f}")
    if args.profile:
        for name, fn in (("code_domain_q6", tcd.code_domain_q6),
                         ("code_domain_q1", tcd.code_domain_q1)):
            log(f"profile {name} " + json.dumps(
                profile_run(lambda fn=fn: fn(session))))
    code_domain_checks(session, tpch, first, want, q6_out, q1_out)
    log("answers ok: code_domain_q6 / code_domain_q1 match the session and "
        "the oracle")

    # 8. the code kernels against their plain versions, on phase 7's inputs
    phase_clock.next(8)
    kres["fused_code_filter_sum"] = code_filter_phase(rec_f.calls,
                                                      args.reps)
    kres["grouped_code_reduce"] = code_grouped_phase(rec_c.calls, args.reps)
    for name in ("fused_code_filter_sum", "grouped_code_reduce"):
        log(f"kernel {name} " + json.dumps(kres[name]))

    # 9. the run-space RLE probe
    phase_clock.next(9)
    try:
        n_rle, rle_rows, rle_first, rle_warm = rle_probe(session, n_rows,
                                                         args.reps)
    except Exception as e:  # noqa: BLE001 - report the phase, then exit
        fail(f"RLE probe: {type(e).__name__}: {e}")
    log(f"rle_probe rows {n_rle} answer {json.dumps(rle_rows)} first_s "
        f"{rle_first:.4f} warm_s {rle_warm:.4f}")

    # 10. the join path: orders LEFT JOIN lineitem (Q3C), then a
    # generic-key join, through the device join engine
    phase_clock.next(10)
    n_orders = int(args.sf * ORDERS_PER_SF)
    t0 = time.perf_counter()
    orders = tpch.gen_orders(n_orders, n_orders // 10, args.seed + 1)
    log(f"orders_gen_s {time.perf_counter() - t0:.3f} rows {n_orders}")
    session.sql(tpch.ORDERS_DDL)
    t0 = time.perf_counter()
    session.insert_arrays("orders", list(orders.values()))
    o_load_s = time.perf_counter() - t0
    log(f"orders_load_s {o_load_s:.3f} rows_per_s {n_orders / o_load_s:.0f}")
    # the expanded output is ~39 B per slot over 134M slots at SF 16 and
    # the build artifact 1.6 GB: the default caps (2 GiB, 1 GiB) would
    # send Q3C to the host join and re-sort every run
    props.join_expand_max_bytes = 8 << 30
    props.join_build_cache_bytes = 8 << 30
    props.pallas_group_reduce = True
    try:
        (q3c_rows, q3c_first, q3c_warm, jmoved, jlaunch, jcalls, peak,
         resident, jprof) = join_path(session, tpch, args.reps, args.profile)
    except Exception as e:  # noqa: BLE001 - report the phase, then exit
        fail(f"join path: {type(e).__name__}: {e}")
    log(f"join_path_counters {json.dumps(jmoved)}")
    log(f"join_path_launches {json.dumps({'grouped_reduce': jlaunch})}")
    if jmoved["join_host_fallbacks"] or jmoved["host_fallbacks"]:
        fail(f"Q3C left the device: {jmoved}")
    if jmoved["join_device_joins"] < 1:
        fail("Q3C ran no device join")
    if jmoved["join_build_sorts"] != 1:
        fail(f"Q3C sorted its build {jmoved['join_build_sorts']} times "
             f"over {1 + args.reps} runs, expected once")
    if jlaunch < 1:
        fail("grouped_reduce did not launch on the join path")
    log(f"q3c_first_s {q3c_first:.4f} warm_s {q3c_warm:.4f} "
        f"lineitem_rows_per_s {n_rows / q3c_warm:.0f} "
        f"expand_bucket {jmoved['join_expand_out_rows'] // (1 + args.reps)}"
        f" peak_device_bytes {peak} resident_before_bytes {resident}")
    if jprof is not None:
        log(f"profile q3c {json.dumps(jprof)}")
    t0 = time.perf_counter()
    want_q3c, want_generic = join_oracle(li, orders, tpch)
    log(f"join_oracle_s {time.perf_counter() - t0:.3f}")
    check_rows("Q3C vs numpy oracle", q3c_rows, want_q3c, 5e-5)
    log(f"q3c {json.dumps(q3c_rows)}")
    # the grouped kernel at the join path's inputs: its own line, so the
    # kernels' line keeps phase 5's main-path numbers
    log(f"kernel grouped_reduce on Q3C "
        f"{json.dumps(grouped_phase(jcalls, args.reps))}")
    del jcalls
    sort_ms, sort_rows = build_sort_ms(session, args.reps)
    log(f"build_sort_ms {sort_ms:.3f} rows {sort_rows}")
    reg = global_registry()
    fb0 = reg.counter("host_fallbacks")
    try:
        t0 = time.perf_counter()
        gen_rows = session.sql(GENERIC_JOIN_QUERY).rows()
        gen_s = time.perf_counter() - t0
    except Exception as e:  # noqa: BLE001 - report the phase, then exit
        fail(f"generic-key join: {type(e).__name__}: {e}")
    if reg.counter("host_fallbacks") != fb0:
        fail("the generic-key join left the device")
    check_rows("generic-key join vs numpy", gen_rows, want_generic, 5e-5)
    log(f"generic_join groups {len(gen_rows)} first_s {gen_s:.4f}")
    log("answers ok: Q3C and the generic-key join match numpy")

    # 29. multi-slot execution: lineitem and orders on a 4-slot mesh of the
    # one card, Q1 / Q6 / Q3C through the per-slot lane, a live resize
    phase_clock.next(29)
    try:
        mesh_launches = mesh_path(session, tpch, want, q3c_rows, warm, args)
    except Exception as e:  # noqa: BLE001 - report the phase, then exit
        fail(f"mesh path: {type(e).__name__}: {e}")
    log(f"mesh_path_launches {json.dumps(mesh_launches)}")
    for name, count in mesh_launches.items():
        launches[name] += count

    # 30. the TPC-DS kit on the same session: its star schema at SF 10,
    # the eight reporting queries against the oracle, the kernels on the
    # inputs they handed them, the native string encoder
    phase_clock.next(30)
    try:
        ds_launches = tpcds_path(session, args)
    except Exception as e:  # noqa: BLE001 - report the phase, then exit
        fail(f"TPC-DS path: {type(e).__name__}: {e}")
    log(f"tpcds_path_launches {json.dumps(ds_launches)}")
    for name, count in ds_launches.items():
        launches[name] += count

    # 11. the tiled lane over lineitem at a tenth of Q1's decoded bind
    phase_clock.next(11)
    units1, ub1, tu1, tiles_q1 = tile_plan(session, "lineitem", Q1_COLS, 1)
    budget = units1 * ub1 // 10
    _u, _b, tu1, tiles_q1 = tile_plan(session, "lineitem", Q1_COLS, budget)
    _u, ub6, tu6, tiles_q6 = tile_plan(session, "lineitem", Q6_COLS, budget)
    log(f"tile_plan units {units1} q1_bind_bytes {units1 * ub1} "
        f"scan_tile_bytes {budget} q1 tile_units {tu1} tiles {tiles_q1} "
        f"q6 tile_units {tu6} tiles {tiles_q6}")
    try:
        (t_rows, t_times, t_up, tmoved, tlaunch, tpeak, tresident, tk_calls,
         tg_calls, tprof) = tiled_path(session, tpch, args.reps, budget,
                                       args.profile)
    except Exception as e:  # noqa: BLE001 - report the phase, then exit
        fail(f"tiled path: {type(e).__name__}: {e}")
    runs = 1 + args.reps
    log(f"tiled_path_counters {json.dumps(tmoved)}")
    log(f"tiled_path_launches {json.dumps(tlaunch)}")
    if tmoved["scan_tiles"] != (tiles_q1 + tiles_q6) * runs:
        fail(f"scan_tiles moved {tmoved['scan_tiles']}, expected "
             f"({tiles_q1} + {tiles_q6}) x {runs}")
    if tmoved["scan_tile_device_merges"] < 1 \
            or tmoved["scan_tile_host_merges"]:
        fail(f"the tiled passes did not merge on the device: {tmoved}")
    if tlaunch["grouped_reduce"] != tiles_q1 * runs:
        fail(f"grouped_reduce launched {tlaunch['grouped_reduce']} times "
             f"over {tiles_q1} Q1 tiles x {runs} runs")
    if tlaunch["masked_kahan_sum"] != tiles_q6 * runs:
        fail(f"masked_kahan_sum launched {tlaunch['masked_kahan_sum']} "
             f"times over {tiles_q6} Q6 tiles x {runs} runs")
    if tmoved["prefetch_windows_warmed"] < 1 \
            or tmoved["prefetch_worker_deaths"]:
        fail(f"the tile prefetcher did not warm windows cleanly: {tmoved}")
    if tmoved["host_fallbacks"]:
        fail("a tiled pass left the device")
    for q in ("q1", "q6"):
        check_rows(f"tiled {q} vs phase 4", t_rows[q], first[q][0])
        check_rows(f"tiled {q} vs numpy oracle", t_rows[q], want[q])
    depth = int(props.tier_prefetch_depth)
    mem_bound = (depth + 2) * budget + 64 * MIB
    log(f"tiled_peak_device_bytes {tpeak} resident_before_bytes "
        f"{tresident} bound {mem_bound}")
    if tpeak > mem_bound:
        fail(f"the tiled pass allocated {tpeak} B above the resident set, "
             f"over the bound {mem_bound}")
    h2d = pinned_h2d_gb_per_s(budget, args.reps)
    for q in ("q1", "q6"):
        ts = t_times[q]
        tw = sorted(ts[1:])[len(ts[1:]) // 2] if args.reps else ts[0]
        up = t_up[q][-1]
        log(f"tiled_{q} first_s {ts[0]:.4f} warm_s {tw:.4f} rows_per_s "
            f"{n_rows / tw:.0f} in_hbm_rows_per_s {n_rows / warm[q]:.0f} "
            f"upload_bytes_per_pass {up} effective_upload_gb_per_s "
            f"{up / tw / 1e9:.3f}")
    log(f"pinned_h2d_gb_per_s {h2d:.3f} ({budget} B copies)")
    log(f"prefetch_overlap_ms {tmoved['prefetch_overlap_ms']} "
        f"window_waits {tmoved['prefetch_window_waits']} "
        f"tile_launch_overlaps {tmoved['scan_tile_prefetch_overlap']}")
    if tprof is not None:
        log(f"profile tiled_q1 {json.dumps(tprof)}")
    # phase 17 profiles the in-HBM plate and the last (shortest) tile, one
    # child process each; the full first tile is timed here only
    kahan_shapes = [("in-HBM Q6", rec_k.calls[0])]
    for label, calls in (("first", tk_calls[:1]), ("last", tk_calls[-1:])):
        log(f"kernel masked_kahan_sum on the {label} tile "
            f"{json.dumps(kahan_phase(calls, args.reps))}")
        if label == "last":
            kahan_shapes.append((f"{label} tile", calls[0]))
    log(f"kernel grouped_reduce on the last tile "
        f"{json.dumps(grouped_phase(tg_calls[-1:], args.reps))}")
    for name in ("masked_kahan_sum", "grouped_reduce"):
        launches[name] += tlaunch[name]
    del tk_calls
    log("answers ok: tiled Q1 and Q6 match phase 4 and the oracle")

    # 12. exact decimals on the card, over the first twelfth of the rows:
    # a second full-size ingest would leave phases 15 - 16 too little of
    # the run's time limit
    phase_clock.next(12)
    n_dec = n_rows // DEC_DEPTH
    try:
        dec = decimal_path(session, tpch,
                           {k: v[:n_dec] for k, v in li.items()},
                           args.reps, budget, args.profile)
    except Exception as e:  # noqa: BLE001 - report the phase, then exit
        fail(f"decimal path: {type(e).__name__}: {e}")
    log(f"decimal_load_s {dec['load_s']:.3f} rows {n_dec} (1/{DEC_DEPTH} "
        f"of lineitem's)")
    for q in ("q1", "q6"):
        log(f"decimal_{q} first_s {dec[q + '_first_s']:.4f} warm_s "
            f"{dec[q + '_warm_s']:.4f} rows_per_s "
            f"{n_dec / dec[q + '_warm_s']:.0f}")
    log(f"decimal_q1_tiled tiles {dec['q1_tiles']} first_s "
        f"{dec['q1_tiled_first_s']:.4f} warm_s {dec['q1_tiled_warm_s']:.4f} "
        f"counters {json.dumps(dec['q1_tiled_counters'])}")
    if dec["q1_tiled_prof"] is not None:
        log(f"profile decimal_q1_tiled {json.dumps(dec['q1_tiled_prof'])}")
    log(f"decimal_q1 {json.dumps([[str(x) for x in r] for r in dec['q1']])}")
    log(f"decimal_overflow_probe {dec['probe']} (host path, counted)")
    log("answers ok: exact-decimal Q1/Q6 match the cents oracle, tiled and "
        "untiled")

    # 13. count(DISTINCT) and the matmul strategy
    phase_clock.next(13)
    try:
        d_rows, d_first, d_warm = distinct_path(session, li, args.reps)
        strat = strategy_timing(tg_calls, args.reps)
    except Exception as e:  # noqa: BLE001 - report the phase, then exit
        fail(f"count(DISTINCT) / strategy: {type(e).__name__}: {e}")
    del tg_calls
    log(f"count_distinct first_s {d_first:.4f} warm_s {d_warm:.4f} "
        f"rows_per_s {n_rows / d_warm:.0f} {json.dumps(d_rows)}")
    log(f"strategy_timing {json.dumps(strat)}")
    log("answers ok: count(DISTINCT) matches numpy; matmul equals scatter")

    # 14. subqueries and functions on the card: Q4, Q22 and the functions
    # query at --sf, Q18 at SF 1
    phase_clock.next(14)
    try:
        sub_launches = subquery_path(session, tpch, li, orders, args)
    except Exception as e:  # noqa: BLE001 - report the phase, then exit
        fail(f"subquery path: {type(e).__name__}: {e}")
    log(f"subquery_path_launches {json.dumps(sub_launches)}")
    for name, count in sub_launches.items():
        if count < 1:
            fail(f"{name} did not launch on the subquery path")
        launches[name] += count

    # 15. window functions over orders, on the device
    phase_clock.next(15)
    try:
        window_path(session, tpch, orders, args)
    except Exception as e:  # noqa: BLE001 - report the phase, then exit
        fail(f"window path: {type(e).__name__}: {e}")

    # 16. mutations at --sf on lineitem: a pinned reader, UPDATE, DELETE,
    # insert, Q1 / Q6 through both kernels, HTAP, row tables
    phase_clock.next(16)
    cust = tpch.gen_customer(n_orders // 10, args.seed + 2)
    try:
        mut_launches, post = mutation_path(session, tpch, li, li_code,
                                           orders, cust, first, args)
    except Exception as e:  # noqa: BLE001 - report the phase, then exit
        fail(f"mutation path: {type(e).__name__}: {e}")
    del cust, li_code
    log(f"mutation_path_launches {json.dumps(mut_launches)}")
    for name, count in mut_launches.items():
        launches[name] += count

    # 21. views, materialized views and SQL functions on the same session:
    # Q15 through its view, rev() / capped() on the device, a
    # materialized Q1 view through folds, a DELETE and a stale refresh,
    # then durable views
    phase_clock.next(21)
    try:
        v_launches, arrs = views_path(session, tpch, li, post, first, args)
    except Exception as e:  # noqa: BLE001 - report the phase, then exit
        fail(f"views path: {type(e).__name__}: {e}")
    del post
    log(f"views_path_launches {json.dumps(v_launches)}")
    for name, count in v_launches.items():
        if count < 1:
            fail(f"{name} did not launch on the views path")
        launches[name] += count

    # 22. prepared statements, the micro-batcher, the group-index cache,
    # a secondary index and a row-level policy on the same session
    phase_clock.next(22)
    try:
        s_launches, arrs, _batch, index = serving_path(session, tpch, arrs,
                                                       args)
    except Exception as e:  # noqa: BLE001 - report the phase, then exit
        fail(f"serving path: {type(e).__name__}: {e}")
    del arrs
    log(f"serving_path_launches {json.dumps(s_launches)}")
    for name, count in s_launches.items():
        if count < 1:
            fail(f"{name} did not launch on the serving path")
        launches[name] += count
    if args.profile:
        serving_profiles(session, tpch)

    # 24. observability and security on the same session: EXPLAIN
    # [ANALYZE] of Q1 / Q6, the tracing layer's cost, grants, the stats
    # service and the query log
    phase_clock.next(24)
    try:
        o_launches = observability_path(session, tpch, index, args)
    except Exception as e:  # noqa: BLE001 - report the phase, then exit
        fail(f"observability path: {type(e).__name__}: {e}")
    del index
    log(f"observability_path_launches {json.dumps(o_launches)}")
    for name, count in o_launches.items():
        if count < 1:
            fail(f"{name} did not launch on the observability path")
        launches[name] += count

    # 25. the front doors on the same session: Flight, Flight SQL, REST
    # and the client, Q1 / Q6 served, a streamed scan, do_put, 1 / 4 / 16
    # Flight clients
    phase_clock.next(25)
    # phase 27's CLI server and phase 28's two data servers come up in
    # processes of their own meanwhile
    cli = CliMember(root, session.device)
    dist = CliMember(root, session.device, n=DIST_SERVERS)
    try:
        try:
            f_launches, flight_warm = front_door_path(session, tpch, args)
        except Exception as e:  # noqa: BLE001 - report the phase, then exit
            fail(f"front-door path: {type(e).__name__}: {e}")
        log(f"front_door_path_launches {json.dumps(f_launches)}")
        for name, count in f_launches.items():
            if count < 1:
                fail(f"{name} did not launch on the front-door path")
            launches[name] += count

        # 27. membership on the same session: a locator, server and lead
        # nodes, Q1 / Q6 through a discovered member, a client and a lead
        # failover, then the CLI's server, `sql -e` and `status`
        phase_clock.next(27)
        try:
            m_launches = membership_path(session, tpch, flight_warm, cli,
                                         args)
        except Exception as e:  # noqa: BLE001 - report the phase, then exit
            fail(f"membership path: {type(e).__name__}: {e}")
        cli.stop()
        log(f"membership_path_launches {json.dumps(m_launches)}")
        for name, count in m_launches.items():
            if count < 1:
                fail(f"{name} did not launch on the membership path")
            launches[name] += count

        # 23. AQP: a stratified sample of a 2M-row lineitem, WITH ERROR,
        # approx_sql and TopK, on a session of its own
        phase_clock.next(23)
        try:
            a_launches = aqp_path(tpch, args)
        except Exception as e:  # noqa: BLE001 - report the phase, then exit
            fail(f"AQP path: {type(e).__name__}: {e}")
        log(f"aqp_path_launches {json.dumps(a_launches)}")
        for name, count in a_launches.items():
            if count < 1:
                fail(f"{name} did not launch on the AQP path")
            launches[name] += count

        # 26. streams on a session of their own: a memory stream of
        # lineitem through both kernels and a window, a keyed Kafka
        # restart, q1_mv over a keyless stream
        phase_clock.next(26)
        try:
            st_launches = stream_path(tpch, li, args)
        except Exception as e:  # noqa: BLE001 - report the phase, then exit
            fail(f"stream path: {type(e).__name__}: {e}")
        log(f"stream_path_launches {json.dumps(st_launches)}")
        for name, count in st_launches.items():
            if count < 1:
                fail(f"{name} did not launch on the stream path")
            launches[name] += count

        # 17. the Kahan kernel under torch.profiler, in a child process
        # whose profiler starts fresh; phase 28's routed ingest runs on
        # a thread of this process meanwhile
        phase_clock.next(17)
        try:
            load = DistLoad(dist, li, tpch)
        except Exception as e:  # noqa: BLE001 - report the phase, then exit
            fail(f"distributed session: {type(e).__name__}: {e}")
        for label, r in kahan_profile_child(kahan_shapes, args.reps, root):
            log(f"kernel masked_kahan_sum profile on the {label} "
                f"{json.dumps(r)}")
        del kahan_shapes, rec_k

        # 28. the distributed session: the lead on the card in this
        # process scatters Q1 / Q6, a scan and an UPDATE over the two
        # data-server processes on the same card; their kernels launch in
        # their own processes (counted there, read over Flight, not in
        # these counters)
        phase_clock.next(28)
        try:
            distributed_path(load, tpch, warm, dist, args)
        except Exception as e:  # noqa: BLE001 - report the phase, then exit
            fail(f"distributed path: {type(e).__name__}: {e}")
        del load
    finally:
        cli.stop()
        dist.stop()
    del flight_warm, cli, dist

    # 18. nested orders: ARRAY / MAP / STRUCT plates on the card
    # the main session's plates are not read again: free the card first
    phase_clock.next(18)
    for info in session.catalog.list_tables():
        getattr(info.data, "_device_cache", {}).clear()
    del session
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    try:
        n_launches = nested_path(tpch, args)
    except Exception as e:  # noqa: BLE001 - report the phase, then exit
        fail(f"nested path: {type(e).__name__}: {e}")
    log(f"nested_path_launches {json.dumps(n_launches)}")
    for name, count in n_launches.items():
        launches[name] += count
    gc.collect()
    torch.cuda.empty_cache()

    # 19. a durable lineitem: WAL, checkpoint, crash-shape recovery and
    # the compactor, over the first 1 / DURABLE_DEPTH of the rows
    phase_clock.next(19)
    n_dur = n_rows // DURABLE_DEPTH
    try:
        d_launches = durable_path(tpch, {k: v[:n_dur] for k, v in li.items()},
                                  args,
                                  kres["grouped_reduce"]["config"]["ops"])
    except Exception as e:  # noqa: BLE001 - report the phase, then exit
        fail(f"durable path: {type(e).__name__}: {e}")
    log(f"durable_path_launches {json.dumps(d_launches)}")
    for name, count in d_launches.items():
        launches[name] += count

    # the result lines
    phase_clock.next(None)
    src = {"masked_kahan_sum": ("snappydata_tpu_torch/csrc/kahan_reduce.cu",
                                "snappydata_tpu/ops/pallas_reduce.py:48"),
           "grouped_reduce": ("snappydata_tpu_torch/csrc/group_reduce.cu",
                              "snappydata_tpu/ops/pallas_group.py:103"),
           "fused_code_filter_sum": (
               "snappydata_tpu_torch/csrc/code_filter_sum.cu",
               "snappydata_tpu/ops/pallas_reduce.py:169"),
           "grouped_code_reduce": (
               "snappydata_tpu_torch/csrc/group_code_reduce.cu",
               "snappydata_tpu/ops/pallas_group.py:321")}
    kernels = []
    for name, r in kres.items():
        kernels.append({
            "name": name, "route": "cuda", "source": src[name][0],
            "replaces": src[name][1], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
