#!/usr/bin/env python3
"""Chip smoke test of greptimedb_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 and the
CUDA toolkit. The first run builds the kernels into
greptimedb_tpu_torch/_build/. Phases:

1. Device: the card's name and power limit, torch and CUDA versions, the
   kernel build time.
2. Kernels against their plain versions, on the card, at the shapes the
   main path gives them (plus a contention case): inputs from a seeded
   torch.Generator with NaNs, dead rows and ties. Counts, rows, min and
   max must match exactly; sums must lie within the stated tolerance of
   the plain version run on float64 copies of the same inputs. Each
   kernel is timed with CUDA events (median of 7 after a warm-up) beside
   its plain version, one library call where PyTorch has one, and the
   least time the card could take (and its share of that time). K2 is
   also timed at the sparse route's shape, at PromQL's two float64
   shapes (the label aggregation, [10,000 x 241] into G+1 = 2, and the
   window buckets, [17,280,000 x 1] into 4,000 x 157 + 1 with max), at
   the RANGE query's ([12 x 17,280,000 x 2] f64 slot-replicated rows into
   4,096 x 256 + 1 with min and max), at lastpoint's boundary subsets
   ([524,288 x 10] and [8,192 x 10] f32 into 4,002) and at a rollup job's
   planes ([17,280,000 x 10] f64 into 4,000 x 720 + 1 with min and max,
   one segment a run of 6 rows, bound reckoned by bytes). K1 also
   runs cases that reach each branch of its windowed design (host-major
   ids, frequent window re-bases, column groups, tiny and ragged n, all
   rows dead, G = 2), logs the plan it launched and its device counters,
   and must show on the headline that its window is sized from the
   card's opt-in shared memory and that its adds stay in that window.
   Each wrapper must refuse an int64 input.
3. The main path at TSBS scale, on disk: the `cpu` table bench.py builds
   (4,000 hosts x 12 h at 10 s = 17,280,000 rows, 10 DOUBLE fields, one
   `hostname` tag, append mode) written through RegionEngine.put into a
   disk-backed engine under a temporary directory, the WAL fsynced at
   every put and the 256 MB auto-flush writing SSTs. Then, through
   QueryEngine.execute_one on cuda, bench.py's six `cpu` queries in three
   storage states — after the ingest (timed: cold, warm p50, a profile),
   after ADMIN flush_table and a restart of the engine in this process,
   and after ADMIN compact_table (a full merge, sort-dedup on the card).
   Every value is held against a float64 numpy oracle over the same
   arrays; `last_path` and each state's kernel launch counts show the
   route. lastpoint takes `lastscan+boundary+dense_fused` in every state:
   Region.scan_last visits the SSTs newest-first and stops early, and
   the boundary gather keeps two rows a host and the memtable's; the
   SSTs visited and pruned and the rows before and after the gather are
   printed, and fewer SSTs than the region holds must be visited. Between the first two states a small write (one more 10 s step
   for every host) and a re-query of double_groupby_all must upload only
   the memtable tail's blocks: the SST parts' blocks are keyed by file
   and hit. The compaction must drop exactly the old files' device
   blocks. These checks run with the partial-aggregate cache off
   (GREPTIMEDB_TPU_PARTIAL_CACHE=0, set in this process around them).
   Then, each with its kernels' counts zeroed just before and read just
   after, on the same table:
   - the sparse route: hostname x minute (2,880,000 groups past the
     dense budget) takes `sparse_fused`, one K2 call and no K1, cache
     off; with the cache on it folds per-part sparse partials
     (`incremental_sparse`): every part misses cold, hits warm, and the
     warm repeat launches K2 only for the memtable tail;
   - the six queries with the cache on in each storage state (a cold
     fill, the warm repeat folding only the tail, still all hits after
     the small write, misses again after the restart, the classic route
     for scans of the compacted file past one device block), warm p50
     beside the cache-off p50;
   - host order statistics: median and percentile beside an avg on K2,
     and a sparse query with a median, exact under host_agg.py's rule.
   - RANGE ... ALIGN at full width, after the ingest (cold, warm p50 of
     5, peak device bytes, a CUPTI profile, a cProfile breakdown) and
     after the compaction: 1 h avg and max and 10 min min at 5 min for
     every host, two K2 calls (one a distinct range) over 12 x 17.28 M
     slot-replicated float64 rows and no K1, every window against numpy
     (avg to rtol 1e-9, min and max exactly, NULL where a window is
     empty); and a FILL PREV / FILL LINEAR query on 8 hosts over the
     first hour at 5 s, one K2 call, against numpy.
   - the host SQL surface, partial cache off: seven dashboard statements
     through execute_sql, each cold, five times warm and once under
     torch.profiler: a CTE top-10 drill-down with IN (SELECT ...), lag
     and rank over the 48,000-group hourly aggregate (the second over a
     derived table), a ROWS moving average over the last hour's 1.44 M
     raw rows, a join of two CTE aggregates, an INSERT ... SELECT
     rollup into cpu_1h and its count, and a SELECT over an aggregate
     view. Every value against numpy (max exactly, avg to rtol 1e-5,
     lag equal to the previous row's avg, ranks from the returned
     avgs); every inner aggregate on K1 or K2, on the route the same
     statement takes alone, with that kernel launched.
   - serving (a), after the host SQL statements: an in-process
     HttpServer with bench.py's clients over real keep-alive HTTP,
     qps_single_groupby (50 clients, 2,000 requests of the
     single-groupby-1-1-1 statement without ORDER BY: they coalesce) and
     qps_mixed_tenants (dash / ops / analytics, 10 clients a tenant; its
     requests cut to MIXED_REQUESTS_CPU and the cut printed). The table
     is past the batcher's 4 Mi-row bound, so no dash batch stacks. Per
     traffic: qps, p50 / p99 / p999 a tenant, errors (none allowed),
     batch events by kind and the mean vmapped width, K1 and K2 launches
     a request, peak device bytes, and the card's idle share over a
     profiled burst of a tenth of the requests; every response body
     against its statement's serial result on the same engine (batching
     off, once a distinct statement), the dash and ops results against
     numpy, and no server or encode thread left after the server stops.
     These phases, and every phase before the front door's, run with
     GTPU_FAST_LANE=0 and GTPU_PLAN_CACHE_ENTRIES=0 (LANE_OFF), as they
     ran before the port had either cache. qps_single_groupby then runs again with the
     JAX defaults (plan cache and fast lane on), with the plan-cache hit
     rate as bench.py computes it, the fast lane's events by kind and
     fallback reason, and the stages' seconds (parse, plan, execute,
     fast_bind, fast_execute) beside the same lines. The mixed
     traffic's SST files and row groups scanned and pruned by the
     per-file index are printed.
   - the index, after serving (a): every SST of `cpu` carries its
     puffin index; `SELECT hostname, max, avg, count(*) ... WHERE
     hostname IN (3 hosts)` with the region's parts and scans dropped
     must decode exactly the row groups the index selects (from the
     footers' row counts), prune some, and match numpy.
   - the wire servers (c), after serving (a): in-process MysqlServer and
     PostgresServer with the JAX defaults, stdlib clients written here.
     single_groupby_1_1_1, cpu_max_all_8, groupby_orderby_limit and
     double_groupby_all over both protocols, partial cache off, each
     equal to the in-process result and that to numpy; double_groupby_all
     over MySQL must launch K1 and the dash statements K2. A MySQL
     prepared dash statement executed for 50 hosts (binary rows against
     numpy; the template must give fast-lane or plan-cache hits), then
     20 MySQL connections x 50 single-groupby statements for qps and
     p50 / p99, every response equal to the in-process one, and no
     server thread left after shutdown().
   - the write protocols (e), after the wire servers, with the JAX
     defaults: the native host library (g++, AVAILABLE must be true; a
     64 MiB CRC32 against zlib; snappy against the pure-Python codec on
     a remote-write body); the first hour of `cpu` (4,000 hosts x 360
     steps = 1,440,000 rows, the ten fields printed with repr) as 288
     line-protocol bodies of 5,000 lines from 8 keep-alive clients to
     /v1/influxdb/write?precision=ms, which auto-creates cpu_lp (not
     append mode: its scans deduplicate; the sort-dedup of its memtable
     is timed): every body 204, rows/s, MB/s, ack p50 / p99 and the
     bodies each lane parsed; count(*) 1,440,000; bench.py's six queries
     FROM cpu_lp (bench.py's ranges, which hold the hour;
     double_groupby_all's 12 h range makes 48,000 groups, K1) and
     double_groupby_all over the hour alone (4,000 groups, K2), partial
     cache off, against numpy over the hour, each launching the kernel
     its route over `cpu` launches; bench.py's ingest_qps in process
     (line-protocol writers of 5,000-line ingestq bodies, one SQL INSERT
     writer of 500 rows at 0.1 s, two readers of the warm `cpu`
     per-minute max, 12 s; every request's keys unique, so count(*) must
     equal the rows acknowledged; group commit on, no write workers);
     the hour's usage_user as 4,000 series over Prometheus remote write
     (WriteRequests of 2,000 samples, cut only if the phase would pass
     its 120 s budget), max_over_time(cpu_usage_user[1h]) at 5 min and
     avg(cpu_usage_user) at 1 min through PromqlEngine on K2 against
     numpy, three remote reads (equality, regex, a narrower range) bit
     for bit against the samples sent; an OTLP metrics request (gauge,
     sum, histogram), 300 OTLP spans, OpenTSDB JSON puts over HTTP and
     `put` lines over the telnet server, each read back with SQL. No
     server thread may outlive the phase. The restart of state 4 replays
     the WAL through native.wal_scan and prints the frames it scanned.
   - PromQL through PromqlEngine.eval_matrix on the card, float64, at a
     5 min step with 1 h windows: max_over_time(cpu{__field__=
     "usage_user"}[1h]) buckets the 17.28 M rows into 4,000 x 157 + 1
     segments through one K2 call (window_stats' scatter flavour),
     stddev(avg_over_time(...)) takes the sums grid path and one K2 call
     with sumsq over the hosts, topk(5, max_over_time(...)) keeps the
     five largest; each against numpy, with its K2 launches, window path,
     a CUPTI profile and a cProfile breakdown.
   Then bench.py's high-cardinality table (config #5: 1,000,000 tags x
   10 points through RegionEngine.put, flushed), `SELECT tag, sum(v)`
   through K1 at G = 1,000,002 with the cache off and K2 a part with it
   on. Then a small non-append table with duplicate keys and
   tombstones, flushed between its write batches and then compacted,
   goes through last-write-wins dedup and is held against a Python
   oracle. Then bench.py's PromQL table (config #3, bench.py:375-475):
   prom_cpu, 10,000 counter series x 24 h at 15 s = 57,600,000 rows in
   28 puts, a flush every 3 and one at the end, and its three TQL EVAL
   queries through execute_one: sum(rate(prom_cpu[360s])) over the day
   at a 360 s step (241 steps, the edges grid path), the trailing 10 min
   sum(rate(prom_cpu[2m])), and avg(avg_over_time(prom_cpu[360s])) (the
   sums grid path), each one K2 call for its label aggregation, held
   against numpy on the generated matrix at rtol 1e-9 (bench.py's
   promql_anchor.eval_rate with the counter zero-crossing limit, and a
   window mean). The data directories are removed at the end.
4. Serving (b) and (c): the mixed traffic again, all 3,000 requests, on
   a second data dir holding bench.py's generator at 4,000 hosts x 1 h at
   10 s (1,440,000 rows, flushed into one SST, so each part is one device
   block): dash siblings stack into vmapped groups, and each group must
   make exactly one K2 call (counted on its own thread). K2 is then held
   against its plain version at the shape a real dash batch of the mean
   width gives it ([M x 360 rows x 1] f32, G+1 = 60 M + 1, max). The dir
   is closed and served by `python -m greptimedb_tpu_torch standalone
   start` as a subprocess: /health, a /v1/sql and a Prometheus
   query_range answer as the in-process server did, and SIGTERM ends it
   with exit code 0. Before it, the same 3,000 mixed requests with the
   JAX defaults: learned templates are fast-lane hits, one serial
   execution each, and no longer vmapped groups, as in the JAX package.
   After it (d), the same dir served by `standalone start -c <toml>`
   with Arrow Flight (`[grpc] enable = true`), MySQL, Postgres and one
   static user: /v1/sql answers 401 without credentials and the
   in-process body with them, MySQL logs in with the right password and
   is refused with a wrong one, Postgres answers a query, the
   `dump-config` text loads back to the defaults, and SIGTERM ends it
   with exit code 0. TLS is left out (a line says so). Its Flight legs,
   with the port's own clients (the port's gRPC, HTTP/2 and Arrow IPC):
   the handshake, a wrong password refused; do_get of double_groupby_all
   at 10-minute bins (24,000 groups: K1), cpu_max_all_8 and
   single_groupby_1_1_1 (K2), each equal to the server's /v1/sql rows
   (avg to rtol 1e-5, every other cell exactly); a region_scan of the
   whole region (1,440,000 rows) equal to the generator's rows, its MB/s;
   a do_put of one more hour (1,440,000 rows) into a fresh table,
   count(*) equal to the rows acknowledged and double_groupby_all over it
   against numpy, its rows/s; the server's K1 and K2 launches from its
   /metrics before and after, both above 0. The legs print their own
   seconds (`(d) flight on the standalone`).
   After (d), (i) the serving fabric: two `standalone start -c <toml>`
   frontends, A and B, each over its own copy of that dir with `[shm]
   fabric = true` and one private fabric_dir, beside a fabric-off
   frontend C over the dir itself and a second fabric-off frontend D
   over another copy, the control (batching off in all four, so every
   statement runs alone; A and B encode in worker processes, C and D in
   threads). /dev/shm's size is printed, and the segments are cut to
   fit when it cannot hold them. A takes a short round of the mixed
   traffic (and double_groupby_all at 1 h and at 10 min, where
   G + 1 = 24,001 puts it on K1); B then takes the same statements
   with other parameters: its first-sighting ms beside C's, and its
   template and plan hits (above 0). Every body of A, B and D equals
   C's byte for byte but in the average columns (`avg(...)`), which K1
   and K2 sum in f32 with atomics and are held to rtol 1e-5; how many
   bodies differ there is printed for each of A, B and the control D,
   and MySQL and Postgres rows match. A 100,000-row
   result goes through A's result arena (one publish, one claim; bytes
   equal C's thread encode) and A's /metrics counts exactly its
   workers' encodes. After A's ALTER TABLE, B's first sighting of a
   shape A published misses it (template and plan) and still answers
   as numpy does. B is SIGKILLed while serving; A answers on; after A
   and C stop no segment, no child process and no detach or corrupt
   event is left. Each frontend's K1 and K2 launches are read from its
   /metrics and must be above 0.
5. Streaming beyond device memory, last: BASELINE.json configs[1]
   (bench.py's bench_double_groupby_100m, bench.py:750-845), cpu_big,
   4,000 hosts x 25,000 points at 10 s = 100,000,000 rows (seed 23),
   puts of 524 points through RegionEngine.put with the WAL fsynced, a
   flush every 4 puts and one at the end. Its double-groupby-all (hour x
   hostname, avg of the 10 fields, 280,000 groups) runs through
   execute_one cold and three times warm, partial cache at its default:
   each run must take `stream_prepared` (lazy SST chunks, blocks of 2 Mi
   rows built on a producer thread, one K1 call a block into an
   accumulator on the card), launch K1 once a block and K2 never, never
   call Region.scan, leave the hot set as it was, keep its host bytes in
   flight within one decoded chunk and depth + 2 blocks, and match a
   float64 numpy oracle (per-put np.bincount sums) at rtol 1e-5. Then one
   profiled and one cProfiled run, and the materialized route on the same
   table (cache off: dense_prepared, K1 over the hot set) cold and warm,
   held to the same oracle, unless MemAvailable is under 3x the scan's
   host bytes. The row count is cut, and the cut printed, only when the
   disk or the run's time limit forces it. The kernel phase times K1 at
   this query's block shape too ([2 Mi x 21] f32, host-major ids over
   G + 1 = 280,071).
6. After the stream phase (its ingest deadline counts from the start
   of the run), config #2 over the metric engine: prom_cpu_m
   (ENGINE = metric) takes the same puts through RegionEngine.put on its
   logical region id, and 20 neighbour logical tables (1,000 series x
   1 h at 15 s each, 4.8 M rows) one put each between them, all in one
   physical region that is not append-mode: the ingest rate, the
   physical SSTs and row groups; the three TQL queries, each first as
   TQL ANALYZE (cold: its spans and the SSTs and row groups the
   `__table` predicate pruned) then three timed runs, one K2 launch a
   run, against numpy at rtol 1e-9 and against prom_cpu's answers;
   the SQL panel `SELECT host, date_bin('1 hour', ts) AS h, avg(val)
   ... GROUP BY host, h` (240,000 groups) as EXPLAIN ANALYZE (the card's
   sort-dedup of 57.6 M rows timed) then three runs, against numpy at
   rtol 1e-5; a neighbour's count, which must prune SSTs or row groups;
   K1 / K2 launches and peak device bytes. Then the file engine:
   bench.py's generator at 4,000 hosts x 1 h (seed SERVE_SEED) ingested
   natively and written as CSV and as gzip'd ndjson; CREATE EXTERNAL
   TABLE over each (the CSV's schema declared, the ndjson's inferred,
   whose DESCRIBE must equal the native table's); the load (the parse
   written by hand) timed apart; single_groupby_1_1_1, cpu_max_all_8 and
   double_groupby_all twice over each, equal to the native table's rows
   and numpy, the second run served from the mtime cache. The data
   directories are removed at the end.
7. The write plane (f), after the stream and engine phases, on the
   main path's data dir (closed after its compaction, kept for this):
   engines built from
   `standalone start`'s default options (cpu/2 write workers, group
   commit with overlap, one maintenance worker). bench.py's ingest_qps
   (as in (e), into fresh tables) once with those defaults and once
   with `ingest.group_commit = false`, each with rows/s, line-protocol
   and SQL ack p50 / p99, read p50, WAL fsyncs, group-commit events,
   rows a commit, maintenance jobs and stalled seconds; 0 errors and
   count(*) equal to the rows acknowledged; no plane thread outlives
   close(). Then ADMIN rollup_table('cpu', '1m') on the 17.28 M-row
   table: one job, exactly one K2 launch and no K1, its device profile
   and host ms by stage, and every plane row against numpy (min, max,
   counts exactly, sums to 1e-12). Then bench.py's coarse rollup query
   (min, max, sum, count(*) by host and 5-minute bin) and
   double_groupby_all, each substituted (`+rollup`) and raw
   (GTPU_ROLLUP_SUBSTITUTE=0), cold with launches and warm p50, against
   numpy and each other. Then ADMIN expire_table on a two-SST table
   (one ten days old): exactly the old SST goes, count(*) follows.
   Before (f), phase (h) runs on a copy of that closed data dir (SSTs
   hard-linked, the rest copied), so (f) still reads the original:
   - parallel decode: a cold Region.scan of `cpu` (every cache dropped)
     with one decode worker and with the engine's auto count, byte for
     byte the same columns; workers, wall ms, the objectstore_read spans
     and the decoded bytes of each. The stream phase (5) decodes its
     files in parallel too and logs its producer and consumer split;
   - flows: CREATE FLOW cpu_hourly (hostname x hour, avg of the ten
     fields, max(usage_user), count(*)); the first ADMIN flush_flow
     folds every row with one K2 call and no K1; one more hour for every
     host in two halves around ADMIN flush_table, and a tick that scans
     exactly 1,440,000 rows, leaves the old SST on disk (pruned by
     sequence) and launches K2 once; the sink against a float64 numpy
     oracle over all hours (avg and max to rtol 1e-9, counts exactly)
     and against the same SELECT run directly (rtol 1e-5); a restart
     whose tick folds nothing, launches nothing and leaves the sink as
     it was; a dirty-span flow (median) against numpy; the tick ms split
     into scan, K2 and the sink merge / write;
   - scripts and plugins: a coprocessor saved through /v1/scripts and run
     through /v1/run-script (torch on the card in the sandbox worker)
     against numpy; a scalar-function plugin in double_groupby_all's
     WHERE, equal to the plain query; an SQL interceptor counted once a
     statement on the fast lane and on the slow lane.
   The stream's ingest deadline pays for (h) by cutting the stream's
   depth (the cut is printed).
   Phase (j), object storage, the remote WAL and COPY, runs before the
   stream (whose ingest deadline pays for it): a fake S3 on 127.0.0.1,
   in a process of its own with a deep accept backlog (SigV4 checked on
   every request; GET with Range, PUT, HEAD, DELETE, paginated
   ListObjectsV2; requests and bytes counted by verb)
   and a standalone engine started from a TOML through options.py with
   `[storage] type = "s3"` against it, `cache_bytes` of 1 GiB, `[wal]
   backend = "remote"` and write workers on. bench.py's `cpu` at 4,000
   hosts x 4 h (5,760,000 rows; the depth cut from 12 h by the run's
   time limit), the first 3 h flushed to the bucket, the 4th hour in
   the remote WAL only (one WAL object PUT a group commit). The engine
   is abandoned without close() or a flush; a second engine on the same
   configuration replays exactly the 1,440,000 unflushed rows from the
   bucket. double_groupby_all (K1 must launch) and cpu_max_all_8 cold
   (every cache dropped, the LRU layer included) and warm (p50 of 5)
   against the float64 numpy oracle, with the fake's GETs and bytes and
   the LRU's hits and misses a query; ADMIN flush_table, after which
   the bucket's WAL prefix must be empty; COPY cpu TO Parquet and
   COPY cpu_copy FROM it (double_groupby_all over both equal: avg to
   rtol 1e-5, the keys byte for byte); one hour through ORC (all hosts,
   1,440,000 rows) and through CSV.gz and ndjson (the first TEXT_HOSTS,
   1,000 hosts, 360,000 rows), each file read once, by COPY FROM, and
   the table it fills held to the same rows (its region's scan, every
   value exactly). Both cuts pay for phase (d)'s Flight legs: the
   separate read of each file before its COPY FROM is gone, and the
   text legs carry a quarter of the hour's hosts; an external table
   over the Parquet file
   (count(*) and a per-host aggregate against numpy); COPY DATABASE TO
   and FROM on a small database; `python3 -m greptimedb_tpu_torch
   export` and `import` in subprocesses. The phase prints its seconds
   and each step's, and joins the fake's threads.
   Phase (l), the cluster, runs after (j), before the stream. Its
   in-process leg: a `Cluster` of three datanodes on the card, bench.py's
   `cpu` created through its frontend PARTITION ON hostname into three
   regions (1,112 / 1,111 / 1,777 hosts on three datanodes), cpu_1h
   (HOSTS x 1 h, seed SERVE_SEED, 1,440,000 rows) through the scatter
   write (each region's count against the rule's, count(*)), a flush,
   then double_groupby_all at 1 h and 10 min bins, cpu_max_all_8,
   single_groupby_1_1_1 and groupby_orderby_limit (the partial-aggregate
   fragment: one K2 launch a fragment that returns partial planes, no
   K1), lastpoint (`last()`, the fragment with the pruning hint),
   high_cpu_all (the rows fragment), each cold and warm (p50 of 5)
   against float64 numpy, with the bytes its fragments return and the
   region rows they scanned; the window statement (usage_user less its
   lag over each host's first WINDOW_MINUTES, `window_pushdown`) and a
   batch of eight single_groupby_1_1_1 dash members (DASH_HOSTS, one
   `vmapped_agg` fragment and one K2 launch a region); K2 at the largest
   region's fragment shape against its plain version; a failover (the
   datanode of region 2 killed, beats and metasrv ticks on a synthetic
   clock until a survivor reopens it from the shared WAL). Its process
   leg: a `ProcessCluster` of three datanode processes on the card (each
   one's seconds to ready and card memory from nvidia-smi's compute
   apps), the same hour through the scatter write (each region's slice
   over do_put into its process), a flush, double_groupby_all (1 h, 10
   min), cpu_max_all_8, lastpoint, the window statement and the dash
   batch, each under a trace of its own, equal to the in-process answer
   (rtol 1e-12) and to numpy, with the K1 / K2 launches the datanodes
   report on their piggybacked spans held to the fragments that returned
   planes (a hedge may add or hide one), K2 at the datanodes' shapes
   against the plain version, then one more 10 s slice acknowledged and
   unflushed, SIGKILL of the largest region's process, beats and ticks
   until a survivor replays the remote WAL: count(*) 1,444,000 and
   double_groupby_all over every acknowledged row against numpy; close
   reaps every child. Its deploy leg: `python -m greptimedb_tpu_torch
   metasrv start`, three `datanode start` on the card and a `frontend
   start` (heartbeats every DEPLOY_HEARTBEAT_S), the hour through the
   frontend's line-protocol route, double_groupby_all (1 h) and
   cpu_max_all_8 over /v1/sql equal to the process leg's answers, kill
   -9 of the largest region's datanode, the metasrv's own ticker failing
   it over within 60 s, the same rows again, every process stopped and
   checked gone. Last, a standalone partitioned table answering
   double_groupby_all (K1) and cpu_max_all_8 (K2) through MergeScan.
   The phase prints each leg's seconds.
   Phase (k), the lint plane, runs after the stream: the lint in a
   subprocess beside a `standalone start` (Flight enabled through its
   environment) under the runtime lockdep, driven for LOCKDEP_SECONDS by
   eight clients (double_groupby_all and cpu_max_all_8 over HTTP, one
   Flight client alternating do_get of double_groupby_all and do_put of
   six points, line-protocol writes, ADMIN flush / compact, a flow's
   ticks); its lock graph must have no cycle and its /metrics K1 and K2
   launches.
   Phase (m), chaos, runs last, after (f), every datanode child on the
   card: the chaos explorer's budget (`explore(runs=3, seed=0,
   num_datanodes=1, steps=24)`: each run's schedule, deadline, ops,
   acknowledged writes, typed failures, WAL objects checked, spawn
   seconds and first count(*); all must pass); seed 0's election run
   over three `metasrv_main` processes (one leader, serialized epochs,
   the follower's 409 hint; the card's memory unchanged by them); the
   hour under chaos (TestProcessClusterChaos at TSBS size: three
   datanode processes under GTPU_CHAOS object-store read failures, a
   tenth of the heartbeats dropped, cpu_1h through the scatter write and
   a flush, cold double_groupby_all and cpu_max_all_8 under a deadline,
   equal to numpy or failed typed within the deadline plus epsilon, with
   the datanodes' K2 launches, a partition that
   degrades typed and starts no failover, a SIGKILL mid-way through 12
   INSERT batches, failover within 30 rounds, count(*) and
   double_groupby_all over every acknowledged row, the injections by
   point, the card's memory back after close); the scenario matrix cut
   to the three CHAOS_MATRIX_KEEP (the cut printed; the other two are
   held by their CPU twins). It prints each leg's seconds.
8. A `kernels` JSON line (with each kernel's launches on every path, the
   PromQL queries', the streamed query's, the RANGE queries', the host
   SQL statements', the five served traffics', the Flight legs', the
   wire phase's, the
   write protocols', the cluster's (l) and the write plane's included
   (the two ingest_qps
   runs, the rollup job, the substituted and raw queries), the index
   query's, the metric engine's and the file engine's, the flows',
   the script's, the plugin query's and the interceptor runs',
   lastpoint's by state, K1's time at the stream's shape and K2's at the
   sparse route's, PromQL's, RANGE's, lastpoint's, the vmapped
   batch's, the rollup job's and the cluster fragment's shapes), the
   card line, and the result
   line.

Exits non-zero, and prints no result line, when CUDA is unavailable, the
port is not beside this script, or any check fails.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# the card's memory rate and float32 rate (NVIDIA H100 SXM data sheet)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F64_OPS_PER_S = 34e12

# bench.py's cpu-only TSBS shape (bench.py:70-86, 149-203)
HOSTS = 4000
HOURS = 12
STEP_S = 10
# the sparse query's shape on that table: hostname x minute groups, and
# the whole scan padded as ops/blocks.py::block_size_for pads it (the
# ingest's rows, 1M-row buckets past 1M)
SPARSE_U = HOSTS * HOURS * 60
#: plane rows of ADMIN rollup_table('cpu', '1m') over the whole table:
#: one a host and minute (the bucket of the newest row stays raw)
ROLLUP_GROUPS = HOSTS * HOURS * 60
SPARSE_PAD_ROWS = -(-HOSTS * HOURS * 3600 // STEP_S // (1 << 20)) * (1 << 20)
#: the memtable tail the ingest leaves (9 puts of 524 points a host, an
#: auto-flush every two): the last put's 128 points a host
LASTPOINT_TAIL_ROWS = 128 * HOSTS
T0_MS = 1456790400000  # 2016-03-01T00:00:00Z
POINTS = HOURS * 3600 // STEP_S
# bench.py's config #3 (bench.py:375-475; BASELINE.json configs[2]):
# prom_cpu, 10,000 counter series x 24 h at 15 s, values 50 * point +
# U(0, 50) from seed 11; `sum(rate(prom_cpu[360s]))` at a 360 s step
# over the whole day is 241 eval steps
PROM_SERIES = 10_000
PROM_HOURS = 24
PROM_STEP_S = 15
PROM_SEED = 11
PROM_EVAL_STEP_S = max(60, PROM_HOURS * 3600 // 240)
PROM_STEPS = PROM_HOURS * 3600 // PROM_EVAL_STEP_S + 1
# the `cpu` table's PromQL queries: 1 h windows at a 5 min step over the
# 12 h, so window_stats buckets each series into 145 + 12 buckets
CPU_EVAL_STEP_S = 300
CPU_RANGE_S = 3600
CPU_STEPS = HOURS * 3600 // CPU_EVAL_STEP_S + 1
CPU_BUCKETS = CPU_STEPS + CPU_RANGE_S // CPU_EVAL_STEP_S
# BASELINE.json configs[1], bench.py's bench_double_groupby_100m
# (bench.py:750-845): cpu_big, 4,000 hosts x 25,000 points at 10 s =
# 100,000,000 rows from seed 23, puts of 524 points (1 << 21 rows over
# 4,000 hosts), a flush every 4 puts and one at the end
STREAM_HOSTS = 4000
STREAM_ROWS = 100_000_000
STREAM_SEED = 23
STREAM_FLUSH_EVERY = 4
STREAM_PUT_POINTS = (1 << 21) // STREAM_HOSTS
STREAM_HOURS = -(-(STREAM_ROWS // STREAM_HOSTS) * STEP_S // 3600)
# host bytes of a scanned row: hostname code, ts, 10 DOUBLE fields, the
# write sequence and the op type (an SST holds the same)
STREAM_ROW_BYTES = 4 + 8 + 8 * 10 + 8 + 1
# the ingest stops at a put boundary once the run is this old, so the
# whole script stays inside its time limit (after it: the stream's
# queries ~125 s at full depth, the metric and file engines ~140 s, the
# flows' phase (h) ~90 s and the write plane ~50 s); a cut is printed.
# 720 s until phase (h) came; it pays for (h) by cutting the stream's
# depth (its ingest has started 510-654 s into full runs, PERF.md), never
# below STREAM_MIN_PUTS puts
STREAM_INGEST_DEADLINE_S = 690.0
STREAM_MIN_PUTS = 2 * STREAM_FLUSH_EVERY
T_START = time.perf_counter()
FIELDS = [f"usage_{n}" for n in (
    "user", "system", "idle", "nice", "iowait", "irq", "softirq",
    "steal", "guest", "guest_nice")]
SEED = 7


class CheckFailed(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---- timing ----------------------------------------------------------------


def cuda_ms(fn, runs: int = 7) -> float:
    """Median milliseconds of `fn` over `runs` runs on the card, CUDA
    events around each run, after one warm-up run."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound(nbytes: float, ops: float, dtype) -> tuple[float, str]:
    import torch

    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    rate = F64_OPS_PER_S if dtype == torch.float64 else F32_OPS_PER_S
    t_ops = ops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---- phase 2: kernels against plain versions -------------------------------


def time_major_ids(n, nbuckets, run, dead_frac, gen, device):
    """Group ids as a time-major scan produces them: `run` consecutive
    rows per bucket, buckets cycling, a share of rows masked into the dead
    segment `nbuckets`."""
    import torch

    ids = (torch.arange(n, device=device) // run % nbuckets).to(torch.int32)
    dead = torch.rand(n, generator=gen, device=device) < dead_frac
    return torch.where(dead, torch.full_like(ids, nbuckets), ids)


def host_hour_ids(n, hosts, points_per_hour, hours, dead_frac, gen, device):
    """double_groupby_all's ids: rows time-major over `hosts`, id =
    hour * (hosts + 1) + host + 1, dead segment G - 1 = hours * (hosts +
    1). Returns (ids, G)."""
    import torch

    g = hours * (hosts + 1) + 1
    r = torch.arange(n, device=device)
    hour = r // hosts // points_per_hour
    ids = (hour * (hosts + 1) + r % hosts + 1).to(torch.int32)
    dead = torch.rand(n, generator=gen, device=device) < dead_frac
    return torch.where(dead, torch.full_like(ids, g - 1), ids), g


def host_major_ids(n, hosts, hours, dead_frac, gen, device):
    """Ids as a host-major scan produces them: the hour varies fastest, so
    neighbouring rows lie a bucket's width (hosts + 1) apart and a chunk's
    ids span every hour, wider than the kernel's window. Returns (ids,
    G)."""
    import torch

    g = hours * (hosts + 1) + 1
    r = torch.arange(n, device=device)
    ids = ((r % hours) * (hosts + 1) + (r // hours) % hosts + 1).to(
        torch.int32)
    dead = torch.rand(n, generator=gen, device=device) < dead_frac
    return torch.where(dead, torch.full_like(ids, g - 1), ids), g


def stream_block_ids(n, device):
    """The ids of the streamed cpu_big query's first block: a file's rows
    sorted by (host, ts), STREAM_FLUSH_EVERY puts of points a host, id =
    hour * (hosts + 1) + host + 1, every row live, so the id jumps by
    hosts + 1 at each hour. Returns (ids, G + 1)."""
    import torch

    per_host = STREAM_FLUSH_EVERY * STREAM_PUT_POINTS
    r = torch.arange(n, device=device)
    hour = (r % per_host) * STEP_S // 3600
    ids = (hour * (STREAM_HOSTS + 1) + r // per_host + 1).to(torch.int32)
    return ids, STREAM_HOURS * (STREAM_HOSTS + 1) + 1


def cpu_bucket_ids(device):
    """The bucket ids window_stats gives K2 for a 1 h window at a 5 min
    step over the `cpu` table: rows sorted by (host, ts), id = host * B +
    ceil(offset / step) + w - 1 (ops/window.py), every row live."""
    import torch

    r = torch.arange(HOSTS * POINTS, device=device)
    host, point = r // POINTS, r % POINTS
    w = CPU_RANGE_S // CPU_EVAL_STEP_S
    b = -(-(point * STEP_S) // CPU_EVAL_STEP_S) + w - 1
    return (host * CPU_BUCKETS + b).to(torch.int32)


def range_ids(device):
    """The ids of the full-width RANGE query's 1 h call (every slot in
    range): the compacted table's rows sorted by (host, ts), replicated
    over RANGE_SLOTS slots, slot j of a row in window (its 5 min slot +
    11 - j) of its host's rank in hostname order: 4,096 x 256 groups.
    Returns (ids [S·N], G + 1)."""
    import torch

    per = ALIGN_S // STEP_S
    lead = RANGE_SLOTS - 1
    cap_b = 1 << (lead + -(-POINTS // per) - 1).bit_length()
    cap_s = 1 << (HOSTS - 1).bit_length()
    rank = torch.from_numpy(np.argsort(host_order())).to(device)
    r = torch.arange(HOSTS * POINTS, device=device)
    host, point = r // POINTS, r % POINTS
    rel = point // per + lead
    j = torch.arange(RANGE_SLOTS, device=device)[:, None]
    ids = (rank[host] * cap_b + rel - j).reshape(-1).to(torch.int32)
    return ids, cap_s * cap_b + 1


def lastpoint_ids(tail_rows, device):
    """The ids of the lastpoint query's K2 call over its boundary subset:
    the visited SST's run start and end of every host (host-major), then
    `tail_rows` memtable rows (time-major, every host a step), id =
    registry code + 1, padded to the subset's block with dead rows.
    Returns (ids, G + 1)."""
    import torch

    from greptimedb_tpu_torch.ops.blocks import block_size_for

    h = torch.arange(HOSTS, device=device, dtype=torch.int32) + 1
    tail = h.repeat(tail_rows // HOSTS)
    live = torch.cat([h.repeat_interleave(2), tail])
    n = block_size_for(len(live))
    g = HOSTS + 2
    pad = torch.full((n - len(live),), g - 1, dtype=torch.int32,
                     device=device)
    return torch.cat([live, pad]), g


def values(n, w, dtype, gen, device, nan_frac=0.0, ties=False):
    import torch

    x = torch.rand((n, w), generator=gen, device=device,
                   dtype=torch.float64) * 100.0
    if ties:
        x = torch.round(x)  # repeated values: ties for min/max
    x = x.to(dtype)
    if nan_frac:
        x[torch.rand((n, w), generator=gen, device=device) < nan_frac] = \
            float("nan")
    return x


def sum_ok(got, want64, absx, dtype) -> tuple[bool, float]:
    """Sum tolerance per cell. f32: |got - want| <= 1e-5 * sum|x|, the
    f32 rounding of an order-free sum of this many terms, with `want` the
    plain version on float64 copies (atomics reorder the additions from
    run to run; an f32 index_add_ reference carries its own sequential
    error, larger than the tolerance at 140 k rows a cell). f64:
    |got - want| <= 1e-12 * sum|x|.
    A cell whose reference is +-inf or NaN (values with infinities) must
    match it exactly."""
    import torch

    got = got.to(torch.float64)
    finite = torch.isfinite(want64)
    same = (got == want64) | (torch.isnan(got) & torch.isnan(want64))
    err = torch.where(finite, (got - want64).abs(), torch.zeros_like(got))
    rel = 1e-5 if dtype == torch.float32 else 1e-12
    ok = bool(((err <= rel * absx) | ~finite).all()
              and (same | finite).all())
    return ok, float(err.max().item()) if err.numel() else 0.0


K1_PLAN_KEYS = ("optin_bytes", "window_ids", "columns_a_group",
                "column_groups", "rows_a_chunk", "staged", "blocks_x",
                "blocks_an_sm", "smem_bytes")
K1_STAT_KEYS = ("rebases", "window_flush_atomics", "direct_global_adds",
                "live_chunks", "sorted_chunks")


def bind_k1_probes(lib):
    """ctypes signatures of segment_sum.cu's two inspection entries, which
    the port itself never calls."""
    import ctypes

    lib.gtpu_segment_sum_plan.argtypes = [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    lib.gtpu_segment_sum_plan.restype = ctypes.c_int
    lib.gtpu_segment_sum_stats.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.gtpu_segment_sum_stats.restype = ctypes.c_int


K2_PLAN_KEYS = ("blocks", "rows_per_warp", "smem_bytes", "privatized",
                "blocks_an_sm")


def bind_k2_probes(lib):
    """ctypes signature of fused_segment_agg.cu's inspection entry, which
    the port itself never calls."""
    import ctypes

    lib.gtpu_fused_segment_agg_plan.argtypes = [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    lib.gtpu_fused_segment_agg_plan.restype = ctypes.c_int


def k2_plan(lib, n, f, g, dtype, flags) -> dict:
    """The grid and accumulators K2 launches for this call."""
    import ctypes

    import torch

    out = (ctypes.c_longlong * len(K2_PLAN_KEYS))()
    rc = lib.gtpu_fused_segment_agg_plan(n, f, g, int(dtype == torch.float64),
                                         flags, out)
    check(rc == 0, f"gtpu_fused_segment_agg_plan: CUDA error {rc}")
    return dict(zip(K2_PLAN_KEYS, list(out)))


def k2_global_g(f, dtype, flags) -> int:
    """The least G whose privatized accumulators pass the 48 KB a block
    takes without the opt-in (fused_segment_agg.cu::plan_fused)."""
    import torch

    es = 8 if dtype == torch.float64 else 4
    planes = 1 + bin(flags).count("1")
    return 48 * 1024 // (f * (planes * es + 4) + 4) + 1


def k2_values(n, f, dtype, kind, ids, gen, device):
    """K2's values: ties and 5 % NaN; for `specials`, +inf in group 1,
    -inf in group 2, both in group 3, zeros of both signs in group 4 and
    only -0.0 in group 5."""
    import torch

    vals = values(n, f, dtype, gen, device, nan_frac=0.05, ties=True)
    if kind == "specials":
        coin = torch.rand((n, f), generator=gen, device=device)
        g = ids[:, None].expand(-1, f)
        inf = float("inf")
        vals[(g == 1) & (coin < 0.01)] = inf
        vals[(g == 2) & (coin < 0.01)] = -inf
        vals[(g == 3) & (coin < 0.01)] = inf
        vals[(g == 3) & (coin > 0.99)] = -inf
        vals[(g == 4) & (coin < 0.5)] = -0.0
        vals[(g == 4) & (coin >= 0.5)] = 0.0
        vals[g == 5] = -0.0
    return vals


def check_zero_signs(got, want64, what) -> None:
    """The sign of every zero cell of sum, min and max matches the plain
    version, but for min and max of group 4: which of -0.0 and +0.0 an
    extreme over both keeps depends on the order of the compares, in the
    plain version as in the kernel. Group 5 (only -0.0) keeps -0.0 for
    min and max; every sum starts from the +0.0 identity, so stays +0.0."""
    import torch

    for k in ("sum", "min", "max"):
        if k not in got:
            continue
        w = want64[k]
        zero = w == 0
        if k != "sum":
            zero[4] = False
        check(bool(zero.any()), f"fused {k} {what}: no zero cells")
        check(torch.equal(torch.signbit(got[k].double()[zero]),
                          torch.signbit(w[zero])),
              f"fused {k} {what}: sign of zero")
    if "min" in got:
        check(bool(torch.signbit(want64["min"][5]).all()),
              f"fused min {what}: group 5 is not -0.0")


def device_ms_a_call(fn, torch, calls: int = 10) -> float:
    """CUPTI device time of `fn`'s launches, averaged over `calls` calls."""
    return device_breakdown(lambda: [fn() for _ in range(calls)],
                            torch)["device_ms"] / calls


def check_k2_call(sk, vals, ids, g, want, torch) -> dict:
    """After a warm-up, one K2 call on the card makes exactly one
    allocation and launches exactly two kernels, both K2's own: no fill
    kernel from Python remains."""
    from torch.profiler import ProfilerActivity, profile

    sk.fused_segment_agg(vals, ids, g, *want)
    torch.cuda.synchronize()
    a0 = torch.cuda.memory_stats()["allocation.all.allocated"]
    sk.fused_segment_agg(vals, ids, g, *want)
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"] - a0
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sk.fused_segment_agg(vals, ids, g, *want)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    res = {"allocations": allocs, "device_launches": len(names),
           "kernels": [k[:48] for k in names]}
    log("K2 one call: " + json.dumps(res))
    check(allocs == 1, f"K2 call made {allocs} allocations, expected 1")
    check(len(names) == 2 and "fused_init_kernel" in names[0]
          and "fused_agg_kernel" in names[1],
          f"K2 call launched {names}, expected its two kernels")
    return res


def k2_host_cost(sk, lib, vals, ids, g, want, torch,
                 calls: int = 1000) -> dict:
    """Host microseconds a call (perf_counter over `calls` calls, no
    synchronise) of the whole wrapper, of the C side's launch plan through
    ctypes, and of the port's output views (`_fused_outputs`)."""
    import ctypes

    flags = sk._flags(*want)
    n, f = vals.shape
    plan_out = (ctypes.c_longlong * len(K2_PLAN_KEYS))()
    is_double = int(vals.dtype == torch.float64)
    ways = {"wrapper": lambda: sk.fused_segment_agg(vals, ids, g, *want),
            "plan_entry": lambda: lib.gtpu_fused_segment_agg_plan(
                n, f, g, is_double, flags, plan_out),
            "views_as_strided": lambda: sk._fused_outputs(vals, g, flags)}
    res = {}
    for name, fn in ways.items():
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        res[name] = (time.perf_counter() - t) / calls * 1e6
        torch.cuda.synchronize()
    log("K2 host us a call: " + json.dumps(res))
    return res


def k1_plan(lib, n, w, g, dtype, plane, ids) -> dict:
    """The window, column groups and grid K1 launches for this call."""
    import ctypes

    import torch

    out = (ctypes.c_longlong * len(K1_PLAN_KEYS))()
    aligned = (plane.data_ptr() | ids.data_ptr()) % 16 == 0
    rc = lib.gtpu_segment_sum_plan(n, w, g, int(dtype == torch.float64),
                                   int(aligned), out)
    check(rc == 0, f"gtpu_segment_sum_plan: CUDA error {rc}")
    return dict(zip(K1_PLAN_KEYS, list(out)))


def k1_stats(lib, reset: bool) -> dict:
    """K1's device counters summed over launches since the last reset."""
    import ctypes

    out = (ctypes.c_ulonglong * len(K1_STAT_KEYS))()
    rc = lib.gtpu_segment_sum_stats(out, int(reset))
    check(rc == 0, f"gtpu_segment_sum_stats: CUDA error {rc}")
    return dict(zip(K1_STAT_KEYS, list(out)))


def check_k1_window(case, torch) -> None:
    """The headline runs the windowed branch: its window is sized from the
    card's opt-in shared memory (not the 48 KB a block gets without it),
    most of its chunks add without atomics, and its global atomics are
    window flushes, far fewer than one per live row and column."""
    plan, stats = case["plan"], case["stats"]
    optin = getattr(torch.cuda.get_device_properties(0),
                    "shared_memory_per_block_optin", plan["optin_bytes"])
    es = 8 if "float64" in case["dtype"] else 4
    window = plan["window_ids"] * plan["columns_a_group"] * es
    n, w = case["shape"]
    cells = n * w
    log("K1 headline window: " + json.dumps({
        "optin_bytes": plan["optin_bytes"], "device_optin_bytes": optin,
        "window_bytes": window, "smem_bytes": plan["smem_bytes"],
        "global_atomics": stats["window_flush_atomics"]
        + stats["direct_global_adds"], "row_cells": cells,
        "sorted_chunk_share": stats["sorted_chunks"]
        / max(stats["live_chunks"], 1)}))
    check(plan["optin_bytes"] == optin and optin > 48 * 1024,
          f"K1 plan reads opt-in {plan['optin_bytes']}, device {optin}")
    check(window > 48 * 1024 and plan["smem_bytes"] <= optin,
          f"K1 window {window} B is not sized past 48 KB")
    check(stats["sorted_chunks"] * 2 > stats["live_chunks"],
          "K1 headline chunks mostly took the atomic path")
    check(stats["direct_global_adds"] * 100 < cells
          and stats["window_flush_atomics"] * 4 < cells,
          f"K1 headline global atomics {stats}: not the windowed branch")


def k2_case(sk, lib, torch, vals, ids, g, want, kind, run) -> dict:
    """One K2 call on the card against its float64 plain version on the
    same inputs (counts, rows, min and max exactly; sums within sum_ok's
    tolerance), then timed beside the plain version with its bound and
    launch plan."""
    mn, mx, sq = want
    n, f = vals.shape
    dtype = vals.dtype
    got = sk.fused_segment_agg(vals, ids, g, mn, mx, sq)
    torch.cuda.synchronize()
    want64 = sk.fused_segment_agg_plain(vals.double(), ids, g, mn, mx,
                                        sq)
    absx = sk.fused_segment_agg_plain(vals.double().abs(), ids, g,
                                      False, False, sq)
    what = f"{n}x{f} G={g} {dtype} {kind}"
    for k in ("count", "rows"):
        check(torch.equal(got[k], want64[k]), f"fused {k} {what}")
    for k in ("min", "max"):
        if k in got:
            check(torch.equal(got[k].double(), want64[k]),
                  f"fused {k} {what}")
    if kind == "specials":
        check_zero_signs(got, want64, what)
    ok, err = sum_ok(got["sum"], want64["sum"], absx["sum"], dtype)
    check(ok, f"fused sum {what}: max err {err}")
    if sq:
        ok_q, err_q = sum_ok(got["sumsq"], want64["sumsq"],
                             absx["sumsq"], dtype)
        check(ok_q, f"fused sumsq {what}: err {err_q}")
    live_mask = (ids >= 0) & (ids < g - 1)
    live = int(live_mask.sum().item())
    es = vals.element_size()
    outs = g * f * (es + 4) + g * 4 + g * f * es * (mn + mx + sq)
    nbytes = 4 * n + live * f * es + outs
    b_ms, b_by = bound(nbytes, live * f * (2 + mn + mx + 2 * sq), dtype)

    def call():
        return sk.fused_segment_agg(vals, ids, g, mn, mx, sq)

    k_ms = cuda_ms(call)
    d_ms = device_ms_a_call(call, torch)
    p_ms = cuda_ms(lambda: sk.fused_segment_agg_plain(vals, ids, g, mn,
                                                      mx, sq), runs=5)
    plan = k2_plan(lib, n, f, g, dtype, sk._flags(*want))
    smem = g * f * ((1 + mn + mx + sq) * es + 4) + g * 4
    check(plan["smem_bytes"] == smem
          and plan["privatized"] == int(smem <= 48 * 1024),
          f"K2 {what}: plan {plan}")
    case = {"shape": [n, f], "G": g, "dtype": str(dtype),
            "want": {"min": mn, "max": mx, "sumsq": sq}, "ids": kind,
            "live_rows": live, "run": run, "max_abs_err": err,
            "ms": k_ms, "device_ms": d_ms, "bound_share": b_ms / k_ms,
            "plain_ms": p_ms, "library_ms": None, "bound_ms": b_ms,
            "bound_by": b_by, "plan": plan}
    log("K2 fused_segment_agg " + json.dumps(case))
    return case


def k2_phase(sk, lib, torch, gen, dev) -> dict:
    """K2 against its float64 plain version, case by case."""
    # K2: fused_segment_agg over raw values. Main-path shapes: the padded
    # blocks of single_groupby_1_1_1 (1,024 rows, F=1, G+1=61),
    # cpu_max_all_8 (32,768 rows, F=10, G+1=9) and groupby_orderby_limit
    # (131,072 rows, F=1, G+1=6); then the contention case (k2[3] is the
    # headline). Then cases that reach each branch: accumulators past
    # 48 KB (global atomics), random ids (peer groups in every warp), tiny
    # and ragged n, every row dead, and infinities and signed zeros.
    bind_k2_probes(lib)
    f32, f64 = torch.float32, torch.float64
    mm, mmq, none = (True, True, False), (True, True, True), \
        (False, False, False)
    gf32, gf64 = (k2_global_g(10, dt, sk._flags(*mmq)) for dt in (f32, f64))
    k2 = []
    cases = [
        # (n, F, G+1, buckets, run, dead share, dtype, (min, max, sumsq),
        #  ids: time-major runs or random; values: plain or specials)
        (1024, 1, 61, 60, 6, 0.65, f32, mm, "runs"),
        (32768, 10, 9, 8, 360 * 8, 0.3, f32, mmq, "runs"),
        (32768, 10, 9, 8, 360 * 8, 0.3, f32, none, "runs"),
        (131072, 1, 6, 5, 6 * HOSTS, 0.08, f32, mm, "runs"),
        (8_388_608, 1, 721, 720, 6 * HOSTS, 0.1, f32, mm, "runs"),
        (32768, 10, 9, 8, 360 * 8, 0.3, f64, mmq, "runs"),
        (8_388_608, 1, 721, 720, 6 * HOSTS, 0.1, f64, mmq, "runs"),
        (262_144, 10, gf32, gf32 - 1, 64, 0.2, f32, mmq, "runs"),
        (262_144, 10, gf64, gf64 - 1, 64, 0.2, f64, mmq, "runs"),
        (131072, 1, 61, 60, 1, 0.1, f32, mm, "random"),
        (1, 1, 6, 5, 6, 0.0, f32, mm, "runs"),
        (31, 1, 6, 5, 6, 0.3, f32, mm, "runs"),
        (1_000_001, 3, 9, 8, 360 * 8, 0.3, f32, mmq, "runs"),
        (100_000, 10, 9, 8, 360 * 8, 1.0, f32, mmq, "runs"),
        (65536, 4, 9, 8, 360 * 8, 0.1, f32, mmq, "specials"),
        # F = 40 (the JAX kernel's cap with sumsq): two 32-field rounds
        (65536, 40, 9, 8, 360 * 8, 0.3, f32, mmq, "runs"),
        # peer groups with every plane, in f64
        (131072, 10, 61, 60, 1, 0.1, f64, mmq, "random"),
        # F = 1 past 48 KB: the global branch's one-lane instance
        (1_000_000, 1, 4097, 4096, 64, 0.2, f32, mmq, "runs"),
        (1_000_000, 1, 4097, 4096, 1, 0.2, f64, mm, "random"),
        # PromQL's two shapes, f64: the label aggregation of bench.py's
        # sum(rate(prom_cpu[360s])) (10,000 series x 241 steps, every row
        # in segment 0, G+1 = 2), and the window buckets of
        # max_over_time(cpu{__field__="usage_user"}[1h]) at step 5 m on
        # the `cpu` table (series-major rows, S x B + 1 segments, max)
        (PROM_SERIES, PROM_STEPS, 2, 1, PROM_SERIES, 0.0, f64, none,
         "runs"),
        (HOSTS * POINTS, 1, HOSTS * CPU_BUCKETS + 1, HOSTS * CPU_BUCKETS,
         0, 0.0, f64, (False, True, False), "prom_buckets"),
        # the sparse route's one call (check 1 of the main path): the
        # padded whole scan of the `cpu` table sorted by hostname x minute,
        # compact ids rising by one every 6 rows, U = 2,880,000 groups +
        # the dead slot, F = 2 (avg(usage_user), max(usage_system))
        (SPARSE_PAD_ROWS, 2, SPARSE_U + 1, SPARSE_U, 6, 0.0, f32,
         (False, True, False), "compact"),
        # the full-width RANGE query's 1 h call: [12 x 17,280,000 x 2]
        # slot-replicated f64 rows (usage_user, usage_system), G+1 =
        # 1,048,577, sum, count, min and max
        (RANGE_SLOTS * HOSTS * POINTS, 2, None, None, 0, 0.0, f64, mm,
         "range"),
        # lastpoint's boundary subsets, the 10 fields in f32 over G+1 =
        # HOSTS + 2: after the ingest (two rows a host of the newest SST
        # and the memtable tail) and after a flush (two rows a host)
        (None, 10, None, None, LASTPOINT_TAIL_ROWS, 0.0, f32, none,
         "lastpoint"),
        (None, 10, None, None, 0, 0.0, f32, none, "lastpoint"),
        # a rollup job's planes (maintenance/rollup.py, ADMIN
        # rollup_table('cpu', '1m')): the deduplicated rows in (hostname,
        # ts) order, the 10 fields in f64, one segment a (host, minute)
        # run of 6 rows, G+1 = HOSTS x 720 + 1, min and max
        (HOSTS * POINTS, 10, ROLLUP_GROUPS + 1, ROLLUP_GROUPS,
         60 // STEP_S, 0.0, f64, mm, "rollup"),
    ]
    branches = set()  # (dtype, F > 1, privatized) of the cases run
    for idx, (n, f, g, nb, run, dead, dtype, want, kind) in enumerate(cases):
        if kind == "random":
            ids = torch.randint(0, nb, (n,), generator=gen, device=dev,
                                dtype=torch.int32)
            ids[torch.rand(n, generator=gen, device=dev) < dead] = nb
        elif kind in ("compact", "rollup"):  # sorted; padding rows dead
            ids = torch.clamp(torch.arange(n, device=dev) // run,
                              max=nb).to(torch.int32)
        elif kind == "prom_buckets":
            ids = cpu_bucket_ids(dev)
        elif kind == "range":
            ids, g = range_ids(dev)
        elif kind == "lastpoint":
            ids, g = lastpoint_ids(run, dev)
            n = len(ids)
        else:
            ids = time_major_ids(n, nb, run, dead, gen, dev)
        vals = k2_values(n, f, dtype, kind, ids, gen, dev)
        case = k2_case(sk, lib, torch, vals, ids, g, want, kind, run)
        branches.add((dtype, f > 1, case["plan"]["privatized"]))
        k2.append(case)
        if idx == 3:
            case["one_call"] = check_k2_call(sk, vals, ids, g, want, torch)
            case["host_us"] = k2_host_cost(sk, lib, vals, ids, g, want,
                                           torch)
        del vals, ids
        torch.cuda.empty_cache()
    # every instance of the kernel ran: f32 and f64, F = 1 and F > 1,
    # privatized and global
    check(len(branches) == 8, f"K2 branches run: {sorted(map(str, branches))}")
    return {"cases": k2, "headline": k2[3], "sparse": k2[-5],
            "promql_label": k2[-7], "promql_buckets": k2[-6],
            "range": k2[-4], "lastpoint_ingest": k2[-3],
            "lastpoint_flushed": k2[-2], "rollup": k2[-1]}


def kernel_phase(sk, lib, torch) -> dict:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    results = {}

    # K1: segment_sum over prepared planes. The five main-path shapes first
    # (k1[0] is the headline), then cases that reach each branch of the
    # windowed kernel.
    k1 = []
    n = 8_388_608
    cases = [(n, 11, torch.float32, "hosthour"),
             (n, 21, torch.float32, "hosthour"),
             (n, 11, torch.float32, "minute"),
             (n, 21, torch.float32, "minute"),
             (n, 11, torch.float64, "hosthour"),
             # the window never holds a chunk's ids: adds go to global memory
             (2_097_152, 11, torch.float32, "hostmajor"),
             # host x hour at two points an hour: the window re-bases often
             (2_097_152, 11, torch.float32, "fewpoints"),
             # W = 33 f32: the columns split into groups
             (2_097_152, 33, torch.float32, "hosthour"),
             # tiny and ragged n (a chunk is 256 rows at W = 11)
             (1, 11, torch.float32, "hosthour"),
             (31, 11, torch.float32, "hosthour"),
             (1000, 11, torch.float32, "hosthour"),
             (257, 11, torch.float32, "hosthour"),
             (100_000, 11, torch.float32, "alldead"),
             (100_000, 11, torch.float32, "g2"),
             # not 16-byte aligned, and rows too wide for the ring: the
             # kernel reads rows and ids from global memory
             (1_000_001, 11, torch.float32, "unaligned"),
             (262_144, 300, torch.float32, "hosthour"),
             # the streamed cpu_big query's block: [2 Mi x 21] host-major
             # rows over G + 1 = 280,071 segments
             (2_097_152, 21, torch.float32, "stream")]
    for n, w, dtype, kind in cases:
        if kind == "hosthour":
            ids, g = host_hour_ids(n, HOSTS, 3600 // STEP_S, HOURS, 0.1, gen,
                                   dev)
        elif kind == "minute":
            g = 61
            ids = time_major_ids(n, 60, 6 * HOSTS, 0.1, gen, dev)
        elif kind == "hostmajor":
            ids, g = host_major_ids(n, HOSTS, HOURS, 0.1, gen, dev)
        elif kind == "fewpoints":
            ids, g = host_hour_ids(n, HOSTS, 2, n // (2 * HOSTS) + 1, 0.1,
                                   gen, dev)
        elif kind == "alldead":
            g = HOURS * (HOSTS + 1) + 1
            ids = torch.full((n,), g - 1, dtype=torch.int32, device=dev)
        elif kind == "g2":  # one live group and the dead segment
            g = 2
            ids = time_major_ids(n, 1, 7, 0.3, gen, dev)
        elif kind == "stream":
            ids, g = stream_block_ids(n, dev)
        if kind == "unaligned":  # views one row into their buffers
            ids, g = host_hour_ids(n + 1, HOSTS, 3600 // STEP_S, HOURS, 0.1,
                                   gen, dev)
            ids = ids[1:]
            plane = values(n + 1, w, dtype, gen, dev).reshape(-1)[w:].view(
                n, w)
        else:
            plane = values(n, w, dtype, gen, dev)
        k1_stats(lib, reset=True)
        got = sk.segment_sum(plane, ids, g)
        torch.cuda.synchronize()
        stats = k1_stats(lib, reset=True)
        want = sk.segment_sum_plain(plane.double(), ids, g)
        absx = sk.segment_sum_plain(plane.double().abs(), ids, g)
        ok, err = sum_ok(got, want, absx, dtype)
        f32_plain_err = float((sk.segment_sum_plain(plane, ids, g).double()
                               - want).abs().max().item())
        check(ok, f"segment_sum {n}x{w} G={g} {dtype} {kind}: max err {err}")
        live = int(((ids >= 0) & (ids < g - 1)).sum().item())
        es = plane.element_size()
        nbytes = 4 * n + live * w * es + g * w * es
        b_ms, b_by = bound(nbytes, live * w, dtype)
        k_ms = cuda_ms(lambda: sk.segment_sum(plane, ids, g))
        p_ms = cuda_ms(lambda: sk.segment_sum_plain(plane, ids, g), runs=5)
        lib_out = torch.zeros((g, w), dtype=dtype, device=dev)
        l_ms = cuda_ms(lambda: lib_out.index_add_(0, ids, plane), runs=5)
        case = {"shape": [n, w], "G": g, "dtype": str(dtype), "ids": kind,
                "max_abs_err": err, "f32_plain_max_abs_err": f32_plain_err,
                "ms": k_ms, "bound_share": b_ms / k_ms, "plain_ms": p_ms,
                "library_ms": l_ms, "bound_ms": b_ms, "bound_by": b_by,
                "plan": k1_plan(lib, n, w, g, dtype, plane, ids),
                "stats": stats}
        log("K1 segment_sum " + json.dumps(case))
        check(case["plan"]["staged"] == int(kind != "unaligned" and w < 300),
              f"K1 {kind} W={w}: staged {case['plan']['staged']}")
        k1.append(case)
        del plane, ids, got, want, absx, lib_out
        torch.cuda.empty_cache()
    results["segment_sum"] = {"cases": k1, "headline": k1[0],
                              "stream": k1[-1]}
    check(k1[0]["G"] == 48013, "K1 headline shape")
    check(k1[-1]["G"] == 280_071, "K1 stream shape")
    check_k1_window(k1[0], torch)

    results["fused_segment_agg"] = k2_phase(sk, lib, torch, gen, dev)

    # refusals: an int64 plane / value matrix is not a kernel input
    bad = torch.ones((64, 3), dtype=torch.int64, device=dev)
    bad_ids = torch.zeros(64, dtype=torch.int32, device=dev)
    for name, fn in (("segment_sum", lambda: sk.segment_sum(bad, bad_ids, 2)),
                     ("fused_segment_agg",
                      lambda: sk.fused_segment_agg(bad, bad_ids, 2))):
        try:
            fn()
        except TypeError as e:
            log(f"{name} refuses int64: {e}")
        else:
            raise CheckFailed(f"{name} accepted an int64 input")
    return results


# ---- phase 3: the main path at TSBS scale, on disk ---------------------------

#: the device the engines run on: the card (None). A rehearsal on the CPU
#: at a small HOSTS and HOURS sets "cpu".
DEVICE = None
#: decoded SST parts a region keeps on the host: the whole table's parts
#: under every projection the six queries use stay decoded
PART_CACHE_BYTES = 16 << 30
#: the partial-aggregate cache's byte budget in this run
PARTIAL_CACHE_BYTES = 2 << 30
#: rows a put (about 2M, as bench.py batches) and the auto-flush
#: threshold (EngineConfig's default, 256 MB of memtable)
BATCH_ROWS = 1 << 21
FLUSH_THRESHOLD_BYTES = 256 << 20


def open_engine(root):
    """A disk-backed engine (WAL fsynced at every put) and a query engine
    over a catalog persisted beside it, both on DEVICE. The maintenance
    plane is off (maintenance_workers=0): flushes and compactions run in
    the caller, so the phases before the write plane's keep their SST
    layouts and their synchronous ADMIN statements."""
    from greptimedb_tpu_torch.catalog import Catalog, FileKv
    from greptimedb_tpu_torch.query import QueryEngine
    from greptimedb_tpu_torch.storage import EngineConfig, RegionEngine

    engine = RegionEngine(EngineConfig(
        data_dir=os.path.join(root, "data"), wal_sync=True,
        flush_threshold_bytes=FLUSH_THRESHOLD_BYTES,
        scan_part_cache_bytes=PART_CACHE_BYTES, maintenance_workers=0),
        device=DEVICE)
    qe = QueryEngine(Catalog(FileKv(os.path.join(root, "catalog.json"))),
                     engine, device=DEVICE)
    return engine, qe


def put_points(engine, info, rng, p0, p1, host_names, fields) -> int:
    """One put of points [p0, p1) for every host; appends the field values
    to `fields` for the oracle."""
    from greptimedb_tpu_torch.datatypes import DictVector, RecordBatch

    n = (p1 - p0) * HOSTS
    cols = {
        "hostname": DictVector(np.tile(np.arange(HOSTS, dtype=np.int32),
                                       p1 - p0), host_names),
        "ts": np.repeat(T0_MS + np.arange(p0, p1, dtype=np.int64)
                        * STEP_S * 1000, HOSTS),
    }
    for f in FIELDS:
        cols[f] = rng.uniform(0.0, 100.0, n)
        fields[f].append(cols[f])
    return engine.put(info.region_ids[0], RecordBatch(info.schema, cols))


def cpu_ddl() -> str:
    """bench.py's `cpu` table: one hostname tag, the ten usage fields."""
    field_defs = ",\n  ".join(f"{f} DOUBLE" for f in FIELDS)
    return f"""
        CREATE TABLE cpu (
          hostname STRING,
          ts TIMESTAMP(3) NOT NULL,
          {field_defs},
          TIME INDEX (ts),
          PRIMARY KEY (hostname)
        ) WITH (append_mode = 'true')
    """


def build_and_ingest(root, rng):
    engine, qe = open_engine(root)
    qe.execute_one(cpu_ddl())
    info = qe.catalog.table("public", "cpu")
    points = HOURS * 3600 // STEP_S
    host_names = np.asarray([f"host_{i}" for i in range(HOSTS)], dtype=object)
    slice_points = max(1, BATCH_ROWS // HOSTS)
    fields = {f: [] for f in FIELDS}
    t0 = time.perf_counter()
    rows = 0
    for p0 in range(0, points, slice_points):
        rows += put_points(engine, info, rng, p0,
                           min(p0 + slice_points, points), host_names, fields)
    ingest_s = time.perf_counter() - t0
    # [points, hosts] views of the same values, for the oracle
    grid = {f: np.concatenate(fields[f]).reshape(points, HOSTS)
            for f in FIELDS}
    region = engine.region(info.region_ids[0])
    log("ingest: " + json.dumps({
        "rows": rows, "seconds": ingest_s, "rows_per_s": rows / ingest_s,
        "puts": -(-points // slice_points), "wal_fsyncs": engine.wal.sync_count,
        "sst_files": len(region.files), "sst_bytes": region.sst_bytes,
        "wal_bytes_written": engine.wal.bytes_written,
        "wal_bytes_on_disk": engine.wal.region_bytes(region.region_id),
        "memtable_rows": region.memtable.num_rows}))
    return engine, qe, rows, grid, host_names


def tsbs_queries(table: str = "cpu"):
    """bench.py's six `cpu` queries (bench.py:233-372), over `table`:
    name -> (SQL, last_path on the card over `cpu`, rows or None when the
    oracle counts them)."""
    t_end = T0_MS + HOURS * 3600 * 1000
    cutoff = T0_MS + (HOURS * 3600 * 1000) * 3 // 4
    avg_list = ", ".join(f"avg({f})" for f in FIELDS)
    max_list = ", ".join(f"max({f})" for f in FIELDS)
    lv_list = ", ".join(f"last_value({f} ORDER BY ts)" for f in FIELDS)
    hosts8 = ", ".join(f"'host_{i}'" for i in range(8))
    return {
        "single_groupby_1_1_1": (
            "SELECT date_bin(INTERVAL '1 minute', ts) AS minute, "
            f"max(usage_user) FROM {table} "
            f"WHERE hostname = 'host_0' AND ts >= {T0_MS} "
            f"AND ts < {T0_MS + 3600 * 1000} "
            "GROUP BY minute ORDER BY minute", "dense_fused", 60),
        "cpu_max_all_8": (
            f"SELECT date_bin(INTERVAL '1 hour', ts) AS hour, {max_list} "
            f"FROM {table} WHERE hostname IN ({hosts8}) "
            f"AND ts >= {T0_MS} AND ts < {T0_MS + 8 * 3600 * 1000} "
            "GROUP BY hour ORDER BY hour", "dense_fused", 8),
        "groupby_orderby_limit": (
            "SELECT date_bin(INTERVAL '1 minute', ts) AS minute, "
            f"max(usage_user) FROM {table} WHERE ts < {cutoff} "
            "GROUP BY minute ORDER BY minute DESC LIMIT 5",
            "bucket_topk+dense_fused", 5),
        "double_groupby_all": (
            f"SELECT date_bin(INTERVAL '1 hour', ts) AS hour, hostname, "
            f"{avg_list} FROM {table} WHERE ts >= {T0_MS} AND ts < {t_end} "
            f"GROUP BY hour, hostname ORDER BY hour, hostname",
            "dense_prepared", HOSTS * HOURS),
        # SSTs newest-first (Region.scan_last), then the series-run
        # boundary rows (_boundary_firstlast): K2 over G+1 = 4,002
        # segments of that subset
        "lastpoint": (
            f"SELECT hostname, {lv_list} FROM {table} GROUP BY hostname",
            "lastscan+boundary+dense_fused", HOSTS),
        # a raw scan: no aggregate, so no last_path
        "high_cpu_all": (
            f"SELECT * FROM {table} WHERE usage_user > 90.0 "
            f"AND ts >= {T0_MS} AND ts < {t_end}", None, None),
    }


def f32_exact(x: np.ndarray) -> np.ndarray:
    """The float64 oracle as the f32 kernels see it: max of f32-cast
    values is the f32 cast of the f64 max."""
    return x.astype(np.float32).astype(np.float64)


def host_index(names: np.ndarray) -> np.ndarray:
    """'host_<i>' strings -> i."""
    uniq, inv = np.unique(names.astype(str), return_inverse=True)
    return np.asarray([int(u[5:]) for u in uniq], dtype=np.int64)[inv]


def check_result(name, res, grid, hours=None):
    """Every value of `res` against the float64 oracle over `grid`
    ([points, hosts] per field; the first `hours` (HOURS unless given) of
    points are the data inside the dashboard window, a later point may
    follow it)."""
    hours = HOURS if hours is None else hours
    per_hour = 3600 // STEP_S
    window = hours * per_hour
    cols = {n: np.asarray(c) for n, c in zip(res.names, res.columns)}
    if name == "single_groupby_1_1_1":
        want = grid["usage_user"][:per_hour, 0].reshape(60, 6).max(axis=1)
        check(np.array_equal(cols["minute"],
                             T0_MS + np.arange(60) * 60_000), name + " keys")
        check(np.array_equal(cols["max(usage_user)"].astype(np.float64),
                             f32_exact(want)), name + " max")
    elif name == "cpu_max_all_8":
        h8 = min(8, hours)
        check(np.array_equal(cols["hour"],
                             T0_MS + np.arange(h8) * 3_600_000),
              name + " keys")
        for f in FIELDS:
            want = grid[f][:h8 * per_hour, :8].reshape(h8, -1).max(axis=1)
            check(np.array_equal(cols[f"max({f})"].astype(np.float64),
                                 f32_exact(want)), f"{name} max({f})")
    elif name == "groupby_orderby_limit":
        # the query's cutoff is 3/4 of the dashboard's HOURS
        cut_pt = min(HOURS * per_hour * 3 // 4, window)
        minutes = np.arange(cut_pt // 6 - 1, cut_pt // 6 - 6, -1)
        want = np.asarray([grid["usage_user"][m * 6:(m + 1) * 6].max()
                           for m in minutes])
        check(np.array_equal(cols["minute"], T0_MS + minutes * 60_000),
              name + " keys")
        check(np.array_equal(cols["max(usage_user)"].astype(np.float64),
                             f32_exact(want)), name + " max")
    elif name == "double_groupby_all":
        order = np.argsort(np.asarray([f"host_{i}" for i in range(HOSTS)]),
                           kind="stable")
        keys = np.repeat(np.arange(hours), HOSTS)
        check(np.array_equal(cols["hour"], T0_MS + keys * 3_600_000),
              name + " hour keys")
        check(np.array_equal(host_index(cols["hostname"]),
                             np.tile(order, hours)), name + " hostname keys")
        for f in FIELDS:
            want = grid[f][:window].reshape(hours, per_hour, HOSTS).mean(
                axis=1)[:, order].reshape(-1)
            got = cols[f"avg({f})"].astype(np.float64)
            check(np.allclose(got, want, rtol=1e-5, atol=0),
                  f"{name} avg({f}): max rel err "
                  f"{np.max(np.abs(got - want) / np.abs(want))}")
    elif name == "lastpoint":
        hosts = host_index(cols["hostname"])
        check(np.array_equal(np.sort(hosts), np.arange(HOSTS)),
              name + " hostname keys")
        for f, col in zip(FIELDS, res.names[1:]):
            check(np.array_equal(cols[col].astype(np.float64),
                                 f32_exact(grid[f][-1, hosts])),
                  f"{name} {col}")
    else:  # high_cpu_all: raw rows, any order, values exact
        hit = grid["usage_user"][:window] > 90.0
        want = np.flatnonzero(hit.reshape(-1))  # point * HOSTS + host
        pts = (cols["ts"].astype(np.int64) - T0_MS) // (STEP_S * 1000)
        got = pts * HOSTS + host_index(cols["hostname"])
        order = np.argsort(got, kind="stable")
        check(np.array_equal(got[order], want),
              f"{name}: {len(got)} rows, {len(want)} expected")
        p, h = np.divmod(want, HOSTS)
        for f in FIELDS:
            check(np.array_equal(cols[f].astype(np.float64)[order],
                                 grid[f][p, h]), f"{name} {f}")


def device_breakdown(fn, torch) -> dict:
    """One run of `fn` under torch.profiler: host wall ms, summed device
    activity ms (kernels and copies, CUPTI), the device's idle share of
    the wall time, and the five largest device activities."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    per: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per[e.name] = per.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    device_ms = sum(per.values())
    top = sorted(per.items(), key=lambda kv: -kv[1])[:5]
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "idle_share": 1.0 - device_ms / wall_ms if wall_ms else None,
            "top": [[k[:60], v] for k, v in top]}


def host_breakdown(fn, top: int = 8) -> dict:
    """One run of `fn` under cProfile: host wall ms and the `top`
    functions by own time (ms), to say where a host-bound query's time
    goes. The profiler slows Python calls, so the shares matter, not the
    sum."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    t = time.perf_counter()
    prof.runcall(fn)
    wall_ms = (time.perf_counter() - t) * 1e3
    stats = pstats.Stats(prof).stats
    rows = sorted(((v[2], f"{os.path.basename(k[0])}:{k[1]}:{k[2]}")
                   for k, v in stats.items()), reverse=True)[:top]
    return {"wall_ms": wall_ms,
            "top_own_ms": [[name, own * 1e3] for own, name in rows]}


def sync(torch):
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def run_queries(qe, sk, torch, grid, state, timed, lib=None) -> dict:
    """The six queries in one storage state, each checked against the
    oracle and its last_path. The kernels' counts are zeroed just before
    and read just after; each state must launch both kernels. `timed`
    adds five warm runs and a profiled one a query."""
    if lib is not None:
        k1_stats(lib, reset=True)
    sk.segment_sum.launches = 0
    sk.fused_segment_agg.launches = 0
    out = {}
    for name, (sql, want_path, want_rows) in tsbs_queries().items():
        k1, k2 = sk.segment_sum.launches, sk.fused_segment_agg.launches
        sync(torch)
        t = time.perf_counter()
        res = qe.execute_one(sql)
        sync(torch)
        cold_ms = (time.perf_counter() - t) * 1e3
        path = qe.executor.last_path
        check(want_rows is None or res.num_rows == want_rows,
              f"{state} {name}: {res.num_rows} rows, expected {want_rows}")
        check(path == want_path, f"{state} {name}: last_path {path}, "
              f"expected {want_path}")
        check_result(name, res, grid)
        out[name] = {"cold_ms": cold_ms, "rows": res.num_rows,
                     "last_path": path,
                     "k1_launches": sk.segment_sum.launches - k1,
                     "k2_launches": sk.fused_segment_agg.launches - k2}
        if timed:
            warm = []
            for _ in range(5):
                t = time.perf_counter()
                qe.execute_one(sql)
                warm.append((time.perf_counter() - t) * 1e3)
            out[name]["warm_p50_ms"] = float(np.median(warm))
        if name == "lastpoint":
            out[name]["scan_last"] = lastpoint_scan(qe, sql)
        log(f"{state} query {name}: " + json.dumps(out[name]))
        if timed and torch.cuda.is_available():
            prof = device_breakdown(lambda: qe.execute_one(sql), torch)
            if name == "lastpoint":
                # the whole-scan route's device ms before lastpoint
                # pruning (PERF.md §5), for comparison
                prof["whole_scan_device_ms_before_pruning"] = 16.570
            out[name]["profile"] = prof
            log(f"{state} profile {name} (one warm run, profiler on): "
                + json.dumps(prof))
        if timed and name == "double_groupby_all":
            log(f"{state} host breakdown of a warm {name}: "
                + json.dumps(host_breakdown(lambda: qe.execute_one(sql))))
    launches = {"segment_sum": sk.segment_sum.launches,
                "fused_segment_agg": sk.fused_segment_agg.launches}
    log(f"{state} launches: " + json.dumps(launches))
    if lib is not None:
        log(f"{state} K1 counters: " + json.dumps(k1_stats(lib, reset=True)))
    for k, v in launches.items():
        check(v > 0, f"{k} was not launched in the {state} state")
    return {"launches": launches, "queries": out}


def lastpoint_scan(qe, sql) -> dict:
    """One more run of the lastpoint query, reading the pruned scan it
    asks the region for: SSTs visited and pruned, rows before and after
    the boundary gather. Fewer SSTs visited than the region holds."""
    got = []
    real = qe.region_engine.scan_last

    def spy(*a, **k):
        got.append(real(*a, **k))
        return got[-1]

    qe.region_engine.scan_last = spy
    try:
        qe.execute_one(sql)
    finally:
        del qe.region_engine.scan_last
    check(len(got) == 1 and got[0] is not None,
          "lastpoint: no pruned scan served the query")
    scan = got[0]
    reduced = scan.__dict__.get("_boundary_fl_cache")
    check(bool(reduced), "lastpoint: no boundary gather on its scan")
    st = scan.stats
    out = {"ssts": st["ssts"], "visited": st["lastpoint_visited"],
           "pruned": st["ssts_pruned"], "rows_scanned": scan.num_rows,
           "rows_after_gather": reduced.num_rows}
    check(st["ssts"] < 2 or st["lastpoint_visited"] < st["ssts"],
          f"lastpoint visited every SST: {out}")
    return out


def hot_set_line(qe, torch) -> str:
    cache = qe.executor.cache
    return json.dumps({
        "resident_bytes": cache.resident_bytes, "h2d_bytes": cache.h2d_bytes,
        "h2d_by_anchor": cache.h2d_by_anchor, "hits": cache.hits,
        "misses": cache.misses,
        "max_memory_allocated": torch.cuda.max_memory_allocated()
        if torch.cuda.is_available() else None})


def main_path_phase(sk, torch, lib=None) -> dict:
    """Ingest through the WAL and auto-flushes, the six queries, a small
    write and its re-query, flush + restart, full compaction: every state
    held against the oracle. The data dir is removed at the end."""
    import shutil
    import tempfile

    from greptimedb_tpu_torch import config
    from greptimedb_tpu_torch.ops.blocks import (
        DEFAULT_BLOCK_ROWS,
        block_size_for,
    )

    # whether the compacted file of the whole table spans several device
    # blocks (the fold's one-block-per-part gate)
    full_multi = block_size_for(HOSTS * (HOURS * 3600 // STEP_S + 1)) \
        > DEFAULT_BLOCK_ROWS
    root = tempfile.mkdtemp(prefix="chip_smoke_")
    kept = False
    try:
        du = shutil.disk_usage(root)
        log(f"disk at {root}: total {du.total}, free {du.free} bytes")
        rng = np.random.default_rng(SEED)
        # 1. ingest
        engine, qe, rows, grid, host_names = build_and_ingest(root, rng)
        check(rows == HOSTS * HOURS * 3600 // STEP_S, "ingested rows")
        info = qe.catalog.table("public", "cpu")
        rid = info.region_ids[0]
        check(len(engine.region(rid).files) >= 2,
              "ingest: the auto-flush left fewer than two SSTs")
        # (h)'s parallel decode over the ingest's SSTs and memtable (the
        # compacted file's case runs in flow_phase); caches dropped after
        decode_ingest = decode_phase(engine, rid, "after the ingest")
        # 2. the six queries on the classic routes (the partial cache
        # off): the main path's launch counts come from here
        with partial_cache(False):
            main = run_queries(qe, sk, torch, grid, "ingest", True, lib)
        log("hot set after the queries: " + hot_set_line(qe, torch))
        # the sparse route, cache off then on; the six queries and the
        # host aggregates with the cache on
        sparse = sparse_phase(qe, sk, torch, grid, engine.region(rid))
        cached = {"ingest": run_cached_queries(
            qe, sk, torch, grid, "ingest", main["queries"],
            engine.region(rid), full_multi)}
        with partial_cache(True):
            host_aggs = host_agg_phase(qe, sk, torch, grid)
        promql_cpu = promql_cpu_phase(qe, sk, torch, grid)
        ranges = {"ingest": range_phase(qe, sk, torch, grid, "ingest", True),
                  "fill": range_fill_phase(qe, sk, torch, grid)}
        host_sql = host_sql_phase(qe, sk, torch, grid)
        serving = serving_cpu_phase(qe, sk, torch, grid)
        index = index_phase(qe, sk, torch, grid)
        wire = wire_phase(qe, sk, torch, grid)
        writes = write_protocols_phase(qe, sk, torch, grid, host_names)
        obs = observability_phase(qe, sk, torch, grid, rows)

        # 3. one more 10 s step for every host, then the re-query: the SST
        # parts' file-anchored blocks hit, only the memtable tail uploads
        fields = {f: [] for f in FIELDS}
        points = HOURS * 3600 // STEP_S
        put_points(engine, info, rng, points, points + 1, host_names, fields)
        grid = {f: np.concatenate([grid[f], fields[f][0][None, :]])
                for f in FIELDS}
        cache = qe.executor.cache
        before = dict(cache.h2d_by_anchor)
        h2d0, hits0 = cache.h2d_bytes, cache.hits
        sql = tsbs_queries()["double_groupby_all"][0]
        with partial_cache(False):
            res = qe.execute_one(sql)
        check_result("double_groupby_all", res, grid)
        tail_rows = engine.region(rid).memtable.num_rows
        elem = torch.finfo(config.compute_dtype(qe.device)).bits // 8
        # hostname int32 + ts int64 + the [values | ones] plane (no NULLs)
        want = block_size_for(tail_rows) * (4 + 8 + (len(FIELDS) + 1) * elem)
        step3 = {"h2d_bytes": cache.h2d_bytes - h2d0,
                 "h2d_file": cache.h2d_by_anchor["file"] - before["file"],
                 "h2d_snap": cache.h2d_by_anchor["snap"] - before["snap"],
                 "tail_rows": tail_rows, "tail_bytes_expected": want,
                 "hits": cache.hits - hits0,
                 "resident_bytes": cache.resident_bytes}
        log("post-flush write, re-query double_groupby_all: "
            + json.dumps(step3))
        check(step3["h2d_file"] == 0 and step3["h2d_snap"] == want
              and step3["h2d_bytes"] == want,
              "the re-query after a small write uploaded more than the "
              "memtable tail's blocks")
        cached["write"] = run_cached_queries(
            qe, sk, torch, grid, "write", {}, engine.region(rid), full_multi)

        # 4. flush, close, reopen on the same data dir in this process
        t = time.perf_counter()
        qe.execute_one("ADMIN flush_table('cpu')")
        flush_s = time.perf_counter() - t
        engine.close()
        t = time.perf_counter()
        engine, qe = open_engine(root)
        region = engine.open_region(rid)
        reopen_s = time.perf_counter() - t
        log("flush + reopen: " + json.dumps({
            "flush_s": flush_s, "reopen_s": reopen_s,
            "wal_entries_replayed": region.replayed_entries,
            "wal_segments_scanned_natively": engine.wal.native_scans,
            "wal_frames_scanned": engine.wal.scanned_frames,
            "sst_files": len(region.files), "sst_bytes": region.sst_bytes,
            "memtable_rows": region.memtable.num_rows}))
        check(engine.wal.native_scans > 0,
              "reopen: the WAL replay did not go through native.wal_scan")
        with partial_cache(False):
            reopened = run_queries(qe, sk, torch, grid, "reopened", False,
                                   lib)
        cached["reopened"] = run_cached_queries(
            qe, sk, torch, grid, "reopened", {}, region, full_multi)

        # 5. full compaction: sort_dedup on the engine's device
        cache = qe.executor.cache
        old = set(region.files)
        check({k[2] for k in cache.file_keys(rid)} == old,
              "reopened: the SST blocks are not all resident")
        t = time.perf_counter()
        with partial_cache(False):
            qe.execute_one("ADMIN compact_table('cpu')")
        compact_s = time.perf_counter() - t
        left = {k[2] for k in cache.file_keys(rid)}
        log("compaction: " + json.dumps({
            "seconds": compact_s, "files_before": len(old),
            "files_after": len(region.files), "sst_bytes": region.sst_bytes,
            "stale_blocks_left": len(left & old)}))
        check(len(region.files) == 1 and not left & old,
              "compaction: the old files' device blocks outlived them")
        with partial_cache(False):
            compacted = run_queries(qe, sk, torch, grid, "compacted", False,
                                    lib)
        check({k[2] for k in cache.file_keys(rid)} == set(region.files),
              "compacted: the merged file's blocks were not rebuilt")
        ranges["compacted"] = range_phase(qe, sk, torch, grid, "compacted",
                                          False)
        cached["compacted"] = run_cached_queries(
            qe, sk, torch, grid, "compacted", {}, region, full_multi)
        engine.close()
        kept = True
    finally:
        if not kept:
            shutil.rmtree(root, ignore_errors=True)
    # the closed data dir and the oracle's arrays stay for the write
    # plane's phase (f), which runs last; main() removes the dir
    return {"launches": main["launches"], "queries": main["queries"],
            "reopened": reopened, "compacted": compacted, "sparse": sparse,
            "cached": cached, "host_aggs": host_aggs,
            "promql_cpu": promql_cpu, "range": ranges, "host_sql": host_sql,
            "serving": serving, "index": index, "wire": wire,
            "writes": writes, "obs": obs, "root": root, "grid": grid,
            "decode_ingest": decode_ingest}


# ---- (j) object storage, the remote WAL and COPY -----------------------------

#: the depth of the S3-backed `cpu` table: 4 h of bench.py's 4,000 hosts
#: (5,760,000 rows), cut from the headline's 12 h by the run's time limit;
#: the first 3 h are flushed, the 4th stays in the remote WAL only
STORE_HOURS = 4
STORE_FLUSH_HOURS = 3
#: points a put: 360,000 rows, one group commit and one WAL object each
STORE_PUT_POINTS = 90
#: points of the small table COPY DATABASE and the export / import CLI
#: carry (all hosts)
STORE_SMALL_POINTS = 30
#: hosts of the hour carried through CSV.gz and ndjson (ORC carries all
#: 4,000): the first 1,000, 360,000 rows, cut from the whole hour to pay
#: for phase (d)'s Flight legs
TEXT_HOSTS = 1000
STORE_SEED = 29
S3_ACCESS, S3_SECRET, S3_REGION = "AKIDCHIPSMOKE", "chip-smoke-secret", \
    "us-east-1"
S3_BUCKET, S3_ROOT = "chip-smoke", "greptimedb"


def serve_fake_s3(conn) -> None:
    """The fake S3's own process (see FakeS3): serves the bucket on
    127.0.0.1 and answers the parent's commands on `conn` until "close"."""
    import html
    import threading
    import urllib.parse
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from greptimedb_tpu_torch.objectstore.s3 import sign_v4

    objects: dict = {}
    lock = threading.Lock()
    counts: dict = {}
    nbytes: dict = {}
    bad = [0]

    def count(verb, n=0):
        with lock:
            counts[verb] = counts.get(verb, 0) + 1
            nbytes[verb] = nbytes.get(verb, 0) + n

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _signed(self) -> bool:
            import datetime

            try:
                now = datetime.datetime.strptime(
                    self.headers.get("x-amz-date", ""),
                    "%Y%m%dT%H%M%SZ").replace(tzinfo=datetime.timezone.utc)
            except ValueError:
                return False
            url = f"http://{self.headers['Host']}{self.path}"
            want = sign_v4(self.command, url, {},
                           self.headers.get("x-amz-content-sha256", ""),
                           S3_ACCESS, S3_SECRET, S3_REGION, now=now)
            return want["Authorization"] == \
                self.headers.get("Authorization", "")

        def _send(self, code, body=b"", length=None, extra=None):
            self.send_response(code)
            for k, v in (extra or {}).items():
                self.send_header(k, v)
            self.send_header("Content-Length", str(
                len(body) if length is None else length))
            self.end_headers()
            if body:
                self.wfile.write(body)

        def _route(self):
            body = b""
            if self.command == "PUT":
                body = self.rfile.read(
                    int(self.headers.get("Content-Length", 0)))
            if not self._signed():
                with lock:
                    bad[0] += 1
                return self._send(403, b"<Error>SignatureDoesNotMatch"
                                       b"</Error>")
            parsed = urllib.parse.urlsplit(self.path)
            q = dict(urllib.parse.parse_qsl(parsed.query))
            parts = parsed.path.lstrip("/").split("/", 1)
            key = urllib.parse.unquote(parts[1]) if len(parts) > 1 else ""
            if parts[0] != S3_BUCKET:
                return self._send(404)
            if self.command == "PUT":
                with lock:
                    objects[key] = body
                count("PUT_WAL" if "/remote_wal/" in key else "PUT",
                      len(body))
                return self._send(200)
            if self.command == "DELETE":
                with lock:
                    objects.pop(key, None)
                count("DELETE")
                return self._send(204)
            if self.command == "GET" and q.get("list-type") == "2":
                prefix = q.get("prefix", "")
                start = q.get("continuation-token", "")
                with lock:
                    keys = sorted(k for k in objects
                                  if k.startswith(prefix) and k > start)
                    sizes = [len(objects[k]) for k in keys[:FakeS3.PAGE]]
                page = keys[:FakeS3.PAGE]
                xml = "<ListBucketResult>" + "".join(
                    f"<Contents><Key>{html.escape(k)}</Key>"
                    f"<Size>{s}</Size></Contents>"
                    for k, s in zip(page, sizes))
                if len(keys) > FakeS3.PAGE:
                    xml += (f"<NextContinuationToken>{html.escape(page[-1])}"
                            f"</NextContinuationToken>")
                xml += "</ListBucketResult>"
                count("LIST")
                return self._send(200, xml.encode())
            with lock:
                data = objects.get(key)
            if data is None:
                count(self.command + "_MISSING")
                return self._send(404)
            if self.command == "HEAD":
                count("HEAD")
                return self._send(200, length=len(data))
            rng = self.headers.get("Range")
            if rng:
                a, _, b = rng[len("bytes="):].partition("-")
                part = data[int(a):int(b) + 1]
                count("GET_RANGE", len(part))
                return self._send(206, part, extra={
                    "Content-Range": f"bytes {a}-{b}/{len(data)}"})
            count("GET", len(data))
            return self._send(200, data)

        do_GET = do_PUT = do_DELETE = do_HEAD = _route

    class Server(ThreadingHTTPServer):
        # the scan's decode workers, the write workers and maintenance
        # connect at once; the default backlog of 5 drops their handshakes
        request_queue_size = FakeS3.BACKLOG
        # server_close() joins every request thread
        daemon_threads = False

    httpd = Server(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=httpd.serve_forever,
                              name="chip-smoke-fake-s3")
    thread.start()
    conn.send(httpd.server_address[1])
    while True:
        cmd, arg = conn.recv()
        if cmd == "close":
            httpd.shutdown()
            thread.join()
            httpd.server_close()
            conn.send(None)
            return
        with lock:
            if cmd == "snapshot":
                out = {"requests": dict(counts), "bytes": dict(nbytes),
                       "bad_signatures": bad[0]}
            elif cmd == "sizes":
                out = {k: len(v) for k, v in sorted(objects.items())
                       if k.startswith(arg)}
            else:
                out = sum(len(v) for v in objects.values())
        conn.send(out)


class FakeS3:
    """An S3 on 127.0.0.1 for phase (j), in a process of its own so that
    the engine's threads never starve its accept loop and request threads
    of the GIL: every request's SigV4 signature is recomputed from the
    shared secret (a mismatch is a 403); GET (with `Range`), PUT, HEAD,
    DELETE and ListObjectsV2 (1,000 keys a page, continuation tokens).
    Requests and bytes are counted by verb (GET, GET_RANGE, LIST, PUT,
    HEAD, DELETE) and, for PUT, by kind (WAL segment or other object).
    `close()` joins the server's threads and its process."""

    PAGE = 1000
    BACKLOG = 256

    def __init__(self):
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        self._conn, child = ctx.Pipe()
        self.proc = ctx.Process(target=serve_fake_s3, args=(child,),
                                name="chip-smoke-fake-s3", daemon=True)
        self.proc.start()
        child.close()
        check(self._conn.poll(60), "(j) the fake S3 did not start")
        self.endpoint = f"http://127.0.0.1:{self._conn.recv()}"

    def _ask(self, cmd: str, arg=None):
        self._conn.send((cmd, arg))
        return self._conn.recv()

    def snapshot(self) -> dict:
        s = self._ask("snapshot")
        return {"requests": s["requests"], "bytes": s["bytes"]}

    @property
    def bad_signatures(self) -> int:
        return self._ask("snapshot")["bad_signatures"]

    def sizes(self, prefix: str) -> dict:
        """Object sizes by key, of the keys under `prefix`."""
        return self._ask("sizes", prefix)

    def keys(self, prefix: str) -> list:
        return list(self.sizes(prefix))

    def stored_bytes(self) -> int:
        return self._ask("stored_bytes")

    def close(self) -> None:
        if self.proc.is_alive():
            self._ask("close")
        self.proc.join(60)
        if self.proc.is_alive():
            self.proc.kill()
            self.proc.join()
        self._conn.close()


def request_delta(a: dict, b: dict) -> dict:
    """Requests and bytes by verb between two FakeS3 snapshots."""
    return {k: {v: b[k].get(v, 0) - a[k].get(v, 0)
                for v in b[k] if b[k].get(v, 0) != a[k].get(v, 0)}
            for k in ("requests", "bytes")}


def store_toml(fake: "FakeS3", home: str) -> str:
    """The standalone configuration phase (j) starts from: SSTs,
    manifests and index files in the fake's bucket behind a 1 GiB read
    cache, the remote WAL in the same bucket, write workers on (cpu/2),
    maintenance on, flushes only when asked."""
    return f"""
[storage]
data_home = "{home}"
type = "s3"
cache_bytes = {1 << 30}

[storage.s3]
bucket = "{S3_BUCKET}"
root = "{S3_ROOT}"
endpoint = "{fake.endpoint}"
region = "{S3_REGION}"
access_key_id = "{S3_ACCESS}"
secret_access_key = "{S3_SECRET}"

[wal]
backend = "remote"

[engine]
write_workers = -1
flush_threshold_bytes = {8 << 30}
"""


def put_grid(engine, info, grid, host_names, p0, p1, hosts) -> int:
    """Points [p0, p1) of the first `hosts` hosts of `grid` as one put."""
    from greptimedb_tpu_torch.datatypes import DictVector, RecordBatch

    cols = {"hostname": DictVector(np.tile(np.arange(hosts, dtype=np.int32),
                                           p1 - p0), host_names[:hosts]),
            "ts": np.repeat(T0_MS + np.arange(p0, p1, dtype=np.int64)
                            * STEP_S * 1000, hosts)}
    for f in FIELDS:
        cols[f] = np.ascontiguousarray(grid[f][p0:p1, :hosts]).reshape(-1)
    return engine.put(info.region_ids[0], RecordBatch(info.schema, cols))


def check_table_rows(t, grid, p0, p1, hosts, what) -> None:
    """A column table read back from a file holds exactly points [p0, p1)
    of the first `hosts` hosts of `grid`, in any row order."""
    from greptimedb_tpu_torch.datasource import _TIME_NS

    tcol = t.column("ts")
    ts_ms = tcol.values.astype(np.int64) * _TIME_NS[tcol.type] // 10**6
    hcol = t.column("hostname")
    if hcol.dictionary is not None and hcol.valid is None \
            and len(hcol.dictionary):
        host = host_index(hcol.dictionary)[hcol.values]
    else:
        host = host_index(hcol.strings())
    check_grid_rows(ts_ms, host, {f: t.column(f).values for f in FIELDS},
                    grid, p0, p1, hosts, what)


def drop_store_caches(qe, engine, region) -> None:
    """Every cache between a query and the bucket: the LRU layer, the
    region's decoded parts and scans, its SST footers and indexes, the
    device hot set and the partial-aggregate cache."""
    from greptimedb_tpu_torch.query import partial_cache as pc

    engine.store.clear()
    clear_region_caches(region)
    region.sst_reader._footers.clear()
    region.sst_reader.index_applier._cache.clear()
    qe.executor.cache.invalidate_region(region.region_id)
    pc.global_cache().clear()


def wait_admin(engine, res) -> None:
    """Wait for the job of an ADMIN statement (maintenance on)."""
    if engine.maintenance is None:
        return
    job = engine.maintenance.wait(int(res.rows()[0][0]), timeout=900)
    check(job.state == "done", f"maintenance job {job.job_id}: {job.state}"
          f" {job.error}")


def store_queries(qe, engine, region, sk, torch, fake, grid) -> dict:
    """double_groupby_all and cpu_max_all_8 over the S3-backed table, cold
    (every cache dropped) and warm (p50 of 5), each held to the float64
    oracle; launches, the fake's requests and the LRU outcomes a run."""
    out = {}
    lru = engine.store
    for name in ("double_groupby_all", "cpu_max_all_8"):
        sql, want_path, _rows = tsbs_queries()[name]
        drop_store_caches(qe, engine, region)
        s0, h0, m0 = fake.snapshot(), lru.hits, lru.misses
        zero_launches(sk)
        res, cold_ms = timed_query(qe, sql, torch)
        k1, k2 = launches(sk)
        path = qe.executor.last_path
        check(path == want_path, f"(j) {name}: last_path {path}, expected "
              f"{want_path}")
        check_result(name, res, grid, hours=STORE_HOURS)
        cold = {"ms": cold_ms, "rows": res.num_rows, "last_path": path,
                "k1_launches": k1, "k2_launches": k2,
                "s3": request_delta(s0, fake.snapshot()),
                "lru_hits": lru.hits - h0, "lru_misses": lru.misses - m0}
        zero_launches(sk)
        s0, h0, m0 = fake.snapshot(), lru.hits, lru.misses
        warm = [timed_query(qe, sql, torch)[1] for _ in range(5)]
        k1w, k2w = launches(sk)
        out[name] = {"cold": cold, "warm_p50_ms": float(np.median(warm)),
                     "warm_ms": warm, "warm_k1_launches": k1w,
                     "warm_k2_launches": k2w,
                     "warm_s3": request_delta(s0, fake.snapshot()),
                     "warm_lru_hits": lru.hits - h0,
                     "warm_lru_misses": lru.misses - m0}
        log(f"(j) query {name} over s3: " + json.dumps(out[name]))
    # a budget under the flushed SST's size (the layer's default 256 MiB
    # at full scale): the SST is served by ranged GETs, never downloaded
    # whole a column chunk
    sql = tsbs_queries()["double_groupby_all"][0]
    sst_bytes = max(n for k, n in fake.sizes("").items()
                    if k.endswith(".sst"))
    budget = min(256 << 20, sst_bytes // 2)
    capacity, lru.capacity = lru.capacity, budget
    try:
        drop_store_caches(qe, engine, region)
        s0 = fake.snapshot()
        zero_launches(sk)
        res, small_ms = timed_query(qe, sql, torch)
        k1, k2 = launches(sk)
        check_result("double_groupby_all", res, grid, hours=STORE_HOURS)
        small = request_delta(s0, fake.snapshot())
    finally:
        lru.capacity = capacity
        drop_store_caches(qe, engine, region)
    check(small["bytes"].get("GET", 0) < sst_bytes
          and 0 < small["bytes"].get("GET_RANGE", 0) <= sst_bytes,
          f"(j) a cold scan under a {budget}-byte cache: {small}, SST "
          f"{sst_bytes} bytes")
    check(k1 > 0, "(j) double_groupby_all under a small cache did not "
          "launch K1")
    out["double_groupby_all"]["cold_small_cache"] = {
        "ms": small_ms, "cache_bytes": budget, "sst_bytes": sst_bytes,
        "k1_launches": k1, "k2_launches": k2, "s3": small}
    log("(j) cold double_groupby_all under a cache smaller than the SST: "
        + json.dumps(out["double_groupby_all"]["cold_small_cache"]))
    check(out["double_groupby_all"]["cold"]["k1_launches"] > 0,
          "(j) double_groupby_all over the S3-backed table did not launch K1")
    check(out["cpu_max_all_8"]["cold"]["k2_launches"] > 0,
          "(j) cpu_max_all_8 over the S3-backed table did not launch K2")
    return out


def copy_phase(qe, engine, sk, torch, grid, host_names, work) -> dict:
    """COPY cpu TO Parquet and back into cpu_copy (double_groupby_all over
    both equal), one hour through ORC (all hosts) and through CSV.gz and
    ndjson (the first TEXT_HOSTS) back to the same rows, an external
    table over the Parquet file, and COPY DATABASE TO / FROM on a small
    database."""
    from greptimedb_tpu_torch import datasource
    from greptimedb_tpu_torch.session import QueryContext

    out, steps = {}, {}
    n_rows = HOSTS * STORE_HOURS * 3600 // STEP_S
    pq_path = os.path.join(work, "copy", "cpu.parquet")
    t = time.perf_counter()
    r = qe.execute_one(f"COPY cpu TO '{pq_path}'")
    steps["copy_to_parquet_s"] = time.perf_counter() - t
    check(r.affected_rows == n_rows, f"(j) COPY cpu TO: {r.affected_rows}")
    # the whole file, every value exactly
    t = time.perf_counter()
    check_table_rows(datasource.read_file(pq_path), grid, 0,
                     n_rows // HOSTS, HOSTS, "(j) cpu.parquet")
    steps["read_check_parquet_s"] = time.perf_counter() - t
    qe.execute_one(cpu_ddl().replace("TABLE cpu (", "TABLE cpu_copy ("))
    t = time.perf_counter()
    r = qe.execute_one(f"COPY cpu_copy FROM '{pq_path}'")
    steps["copy_from_parquet_s"] = time.perf_counter() - t
    check(r.affected_rows == n_rows, f"(j) COPY cpu_copy FROM: "
          f"{r.affected_rows}")
    sql = tsbs_queries()["double_groupby_all"][0]
    a = qe.execute_one(sql)
    zero_launches(sk)
    b, copy_ms = timed_query(qe, tsbs_queries("cpu_copy")[
        "double_groupby_all"][0], torch)
    k1, k2 = launches(sk)
    check(list(a.names) == list(b.names) and a.num_rows == b.num_rows,
          "(j) double_groupby_all over cpu_copy: shape")
    worst = 0.0
    for name, ca, cb in zip(a.names, a.columns, b.columns):
        ca, cb = np.asarray(ca), np.asarray(cb)
        if name.startswith("avg("):
            ca, cb = ca.astype(np.float64), cb.astype(np.float64)
            check(np.allclose(cb, ca, rtol=1e-5, atol=0),
                  f"(j) cpu_copy {name}")
            worst = max(worst, float(np.max(np.abs(cb - ca) / np.abs(ca))))
        else:
            check(np.array_equal(ca, cb), f"(j) cpu_copy {name} keys")
    check(k1 > 0, "(j) double_groupby_all over cpu_copy did not launch K1")
    out["cpu_copy"] = {"ms": copy_ms, "k1_launches": k1, "k2_launches": k2,
                       "max_rel_err_avg": worst,
                       "parquet_bytes": os.path.getsize(pq_path)}
    log("(j) COPY cpu TO / cpu_copy FROM parquet: " + json.dumps(
        {**out["cpu_copy"], **steps}))

    # one hour through ORC (all hosts), CSV.gz and ndjson (TEXT_HOSTS)
    per_hour = 3600 // STEP_S
    text_hosts = min(HOSTS, TEXT_HOSTS)
    for table, hosts in (("cpu_hour", HOSTS), ("cpu_hour_text", text_hosts)):
        qe.execute_one(cpu_ddl().replace("TABLE cpu (", f"TABLE {table} ("))
        put_grid(engine, qe.catalog.table("public", table), grid,
                 host_names, 0, per_hour, hosts)
    fmts = {}
    for ext in ("orc", "csv.gz", "ndjson"):
        src, hosts = ("cpu_hour", HOSTS) if ext == "orc" \
            else ("cpu_hour_text", text_hosts)
        rows = per_hour * hosts
        path = os.path.join(work, "copy", f"hour.{ext}")
        dst = "back_" + ext.replace(".", "_")
        t = time.perf_counter()
        r = qe.execute_one(f"COPY {src} TO '{path}'")
        w_s = time.perf_counter() - t
        check(r.affected_rows == rows, f"(j) COPY TO {ext}")
        # each file is read once, by COPY FROM; the table it fills then
        # holds every value exactly (its region's scan against the grid)
        qe.execute_one(cpu_ddl().replace("TABLE cpu (", f"TABLE {dst} ("))
        t = time.perf_counter()
        r = qe.execute_one(f"COPY {dst} FROM '{path}'")
        f_s = time.perf_counter() - t
        check(r.affected_rows == rows, f"(j) COPY FROM {ext}")
        check_scan_rows(engine.scan(qe.catalog.table(
            "public", dst).region_ids[0]), grid, 0, per_hour, hosts,
            f"(j) hour.{ext} through COPY {dst} FROM")
        n = qe.execute_one(f"SELECT count(*), sum(usage_user) FROM {dst}")
        want_sum = grid["usage_user"][:per_hour, :hosts].sum()
        check(n.rows()[0][0] == rows
              and np.isclose(n.rows()[0][1], want_sum, rtol=1e-5),
              f"(j) {dst}: {n.rows()}")
        fmts[ext] = {"rows": rows, "bytes": os.path.getsize(path),
                     "copy_to_s": w_s, "copy_from_s": f_s,
                     "rows_per_s_write": rows / w_s,
                     "rows_per_s_read": rows / f_s}
    out["formats"] = fmts
    log(f"(j) one hour through orc ({HOSTS} hosts), csv.gz and ndjson (the "
        f"first {text_hosts}): " + json.dumps(fmts))

    # an external table over the Parquet file
    zero_launches(sk)
    qe.execute_one(f"CREATE EXTERNAL TABLE cpu_ext WITH "
                   f"(location = '{pq_path}')")
    t = time.perf_counter()
    cnt = qe.execute_one("SELECT count(*) FROM cpu_ext").rows()[0][0]
    agg = qe.execute_one("SELECT hostname, max(usage_user), avg(usage_idle) "
                         "FROM cpu_ext GROUP BY hostname ORDER BY hostname")
    ext_s = time.perf_counter() - t
    k1, k2 = launches(sk)
    check(cnt == n_rows, f"(j) count(*) over cpu_ext: {cnt}")
    order = np.argsort(np.asarray([f"host_{i}" for i in range(HOSTS)]),
                       kind="stable")
    cols = [np.asarray(c) for c in agg.columns]
    check(np.array_equal(host_index(cols[0]), order), "(j) cpu_ext hosts")
    check(np.array_equal(cols[1].astype(np.float64), f32_exact(
        grid["usage_user"].max(axis=0)[order])), "(j) cpu_ext max")
    check(np.allclose(cols[2].astype(np.float64),
                      grid["usage_idle"].mean(axis=0)[order], rtol=1e-5),
          "(j) cpu_ext avg")
    out["external"] = {"seconds": ext_s, "k1_launches": k1,
                       "k2_launches": k2, "path": qe.executor.last_path}
    log("(j) external parquet table: " + json.dumps(out["external"]))

    # COPY DATABASE TO / FROM on a small database
    t = time.perf_counter()
    for db in ("smalldb", "smalldb2"):
        qe.execute_one(f"CREATE DATABASE {db}")
        qe.execute_one(cpu_ddl(), QueryContext(db=db))
    put_grid(engine, qe.catalog.table("smalldb", "cpu"), grid, host_names,
             0, STORE_SMALL_POINTS, HOSTS)
    db_dir = os.path.join(work, "copy", "smalldb")
    n_small = STORE_SMALL_POINTS * HOSTS
    r1 = qe.execute_one(f"COPY DATABASE smalldb TO '{db_dir}'")
    r2 = qe.execute_one(f"COPY DATABASE smalldb2 FROM '{db_dir}'")
    q = "SELECT count(*), sum(usage_user), max(usage_system) FROM cpu"
    a = qe.execute_one(q, QueryContext(db="smalldb")).rows()
    b = qe.execute_one(q, QueryContext(db="smalldb2")).rows()
    # count and max exactly; the sum is the card's f32 atomics (rtol 1e-5)
    check(r1.affected_rows == r2.affected_rows == n_small
          and a[0][0] == b[0][0] == n_small and a[0][2] == b[0][2]
          and np.isclose(a[0][1], b[0][1], rtol=1e-5),
          f"(j) COPY DATABASE: {r1.affected_rows}, {r2.affected_rows}, "
          f"{a}, {b}")
    # and every value of the copied table exactly
    back = os.path.join(work, "copy", "smalldb2_cpu.parquet")
    qe.execute_one(f"COPY cpu TO '{back}'", QueryContext(db="smalldb2"))
    check_table_rows(datasource.read_file(back), grid, 0,
                     STORE_SMALL_POINTS, HOSTS, "(j) COPY DATABASE rows")
    out["copy_database"] = {"rows": n_small,
                            "seconds": time.perf_counter() - t}
    out["steps"] = steps
    return out


def export_import_phase(grid, host_names, work) -> dict:
    """`python3 -m greptimedb_tpu_torch export` then `import` in
    subprocesses, on a small local database; the imported rows equal the
    exported ones."""
    from greptimedb_tpu_torch import cli, datasource

    t = time.perf_counter()
    homes = [os.path.join(work, n) for n in ("cli_src", "cli_dst")]
    dump = os.path.join(work, "cli_dump")
    engine, qe = cli.build_standalone(homes[0], device=DEVICE)
    qe.execute_one(cpu_ddl())
    put_grid(engine, qe.catalog.table("public", "cpu"), grid, host_names, 0,
             STORE_SMALL_POINTS, HOSTS)
    q = "SELECT hostname, count(*), sum(usage_user) FROM cpu GROUP BY " \
        "hostname ORDER BY hostname"
    want = qe.execute_one(q).rows()
    engine.close()
    dev = ["--device", DEVICE] if DEVICE else []
    env = dict(os.environ, PYTHONPATH=HERE)
    runs = {}
    for cmd, args in (("export", ["--data-home", homes[0], "--output-dir",
                                  dump]),
                      ("import", ["--data-home", homes[1], "--input-dir",
                                  dump])):
        t1 = time.perf_counter()
        p = subprocess.run([sys.executable, "-m", "greptimedb_tpu_torch", cmd]
                           + args + dev, cwd=HERE, env=env,
                           capture_output=True, text=True, timeout=300)
        runs[cmd] = {"rc": p.returncode, "seconds": time.perf_counter() - t1,
                     "stdout": p.stdout.strip()}
        check(p.returncode == 0, f"(j) {cmd}: rc {p.returncode}: "
              f"{p.stderr[-2000:]}")
    back = os.path.join(work, "cli_back.parquet")
    engine, qe = cli.build_standalone(homes[1], device=DEVICE)
    try:
        got = qe.execute_one(q).rows()
        qe.execute_one(f"COPY cpu TO '{back}'")
    finally:
        engine.close()
    check_table_rows(datasource.read_file(back), grid, 0,
                     STORE_SMALL_POINTS, HOSTS, "(j) imported rows")
    # hosts and counts exactly; the sums are the card's f32 atomics in
    # two engines (rtol 1e-5)
    check(len(got) == len(want) and all(
        g[:2] == w[:2] and np.isclose(g[2], w[2], rtol=1e-5)
        for g, w in zip(got, want)),
        "(j) export / import: the imported rows differ")
    runs["seconds"] = time.perf_counter() - t
    log("(j) export / import subprocesses: " + json.dumps(runs))
    return runs


def object_store_phase(sk, torch, card: str) -> dict:
    """Phase (j): a standalone engine started from a TOML with its SSTs,
    manifests and index files in a fake S3 bucket behind the LRU cache and
    its WAL in the same bucket (the remote WAL), write workers on; TSBS
    cpu ingested (3 h flushed, the 4th hour in the WAL only), the engine
    abandoned without close() or a flush, a failover engine replaying the
    unflushed hour from the bucket, the two queries through K1 and K2 cold
    and warm against numpy, a flush whose obsolete empties the WAL prefix,
    COPY in four formats, an external Parquet table, COPY DATABASE and
    the export / import CLI."""
    import shutil
    import tempfile

    from greptimedb_tpu_torch import cli, options
    from greptimedb_tpu_torch.objectstore import LruCacheLayer
    from greptimedb_tpu_torch.storage.remote_wal import RemoteWal
    from greptimedb_tpu_torch.utils.metrics import INGEST_GROUP_COMMIT_EVENTS

    t_phase = time.perf_counter()
    steps = {}
    work = tempfile.mkdtemp(prefix="chip_smoke_store_")
    fake = FakeS3()
    engines = []
    try:
        home = os.path.join(work, "home")
        cfg = os.path.join(work, "standalone.toml")
        with open(cfg, "w") as f:
            f.write(store_toml(fake, home))
        opts = options.load_options(cfg, env={})
        options.check_port_support(opts)
        engine, qe = cli.build_standalone(home, device=DEVICE, opts=opts)
        engines.append(engine)
        check(isinstance(engine.store, LruCacheLayer)
              and engine.store.inner.name == "s3"
              and isinstance(engine.wal, RemoteWal)
              and engine.workers is not None,
              "(j) the TOML did not give an s3 store, the read cache, the "
              "remote WAL and write workers")
        qe.execute_one(cpu_ddl())
        info = qe.catalog.table("public", "cpu")
        rid = info.region_ids[0]
        host_names = np.asarray([f"host_{i}" for i in range(HOSTS)],
                                dtype=object)
        rng = np.random.default_rng(STORE_SEED)
        points = STORE_HOURS * 3600 // STEP_S
        flush_at = STORE_FLUSH_HOURS * 3600 // STEP_S
        fields = {f: [] for f in FIELDS}

        t = time.perf_counter()
        s0 = fake.snapshot()
        for p0 in range(0, flush_at, STORE_PUT_POINTS):
            put_points(engine, info, rng, p0,
                       min(p0 + STORE_PUT_POINTS, flush_at), host_names,
                       fields)
        steps["ingest_3h_s"] = time.perf_counter() - t
        t = time.perf_counter()
        wait_admin(engine, qe.execute_one("ADMIN flush_table('cpu')"))
        steps["flush_3h_s"] = time.perf_counter() - t
        region = engine.region(rid)
        s1 = fake.snapshot()
        wal_prefix = f"{S3_ROOT}/" + os.path.join(
            home, "data", "remote_wal", str(rid)).lstrip("/") + "/"
        left = fake.keys(wal_prefix)
        log("(j) ingest of 3 h and its flush to s3: " + json.dumps({
            "rows": flush_at * HOSTS, "ingest_s": steps["ingest_3h_s"],
            "flush_s": steps["flush_3h_s"], "sst_files": len(region.files),
            "sst_bytes": region.sst_bytes, "wal_objects_after": len(left),
            "s3": request_delta(s0, s1)}))
        # the flush's obsolete empties the WAL prefix: a segment left here
        # would sit in the bucket beside the 4th hour's until the next flush
        check(not left, f"(j) obsolete after the 3 h flush left {left}")
        # the 4th hour: acknowledged, in the bucket's WAL objects only
        leads0 = INGEST_GROUP_COMMIT_EVENTS.get(event="lead")
        t = time.perf_counter()
        puts = 0
        for p0 in range(flush_at, points, STORE_PUT_POINTS):
            put_points(engine, info, rng, p0,
                       min(p0 + STORE_PUT_POINTS, points), host_names,
                       fields)
            puts += 1
        steps["ingest_4th_hour_s"] = time.perf_counter() - t
        s2 = fake.snapshot()
        commits = INGEST_GROUP_COMMIT_EVENTS.get(event="lead") - leads0
        wal_puts = s2["requests"].get("PUT_WAL", 0) - \
            s1["requests"].get("PUT_WAL", 0)
        other_puts = s2["requests"].get("PUT", 0) - \
            s1["requests"].get("PUT", 0)
        log("(j) the 4th hour into the remote WAL: " + json.dumps({
            "rows": (points - flush_at) * HOSTS, "puts": puts,
            "group_commits": commits, "wal_object_puts": wal_puts,
            "other_object_puts": other_puts,
            "seconds": steps["ingest_4th_hour_s"],
            "wal_bytes": s2["bytes"].get("PUT_WAL", 0)
            - s1["bytes"].get("PUT_WAL", 0)}))
        check(wal_puts == commits == puts and other_puts == 0,
              f"(j) group commit: {puts} puts, {commits} commits, "
              f"{wal_puts} WAL object PUTs, {other_puts} other PUTs")
        grid = {f: np.concatenate(fields[f]).reshape(points, HOSTS)
                for f in FIELDS}

        # the crash: the engine is abandoned (no close(), no flush); a
        # failover engine on the same configuration replays the bucket
        crashed = engine
        t = time.perf_counter()
        engine, qe = cli.build_standalone(home, device=DEVICE, opts=opts)
        engines.append(engine)
        region = engine.open_region(rid)
        steps["failover_replay_s"] = time.perf_counter() - t
        s3_ = fake.snapshot()
        unflushed = (points - flush_at) * HOSTS
        replay = {"replayed_entries": region.replayed_entries,
                  "replayed_rows": region.memtable.num_rows,
                  "expected_rows": unflushed,
                  "wal_segments_read": engine.wal.replayed_segments,
                  "seconds": steps["failover_replay_s"],
                  "s3": request_delta(s2, s3_)}
        log("(j) failover replay from the bucket: " + json.dumps(replay))
        check(region.replayed_entries == puts
              and region.memtable.num_rows == unflushed,
              f"(j) failover replay: {json.dumps(replay)}")
        # the abandoned engine's threads end now; its close writes nothing
        crashed.close()
        engines.remove(crashed)
        s4 = fake.snapshot()
        check(request_delta(s3_, s4)["requests"] == {},
              f"(j) closing the abandoned engine touched the bucket: "
              f"{request_delta(s3_, s4)}")

        with partial_cache(False):
            queries = store_queries(qe, engine, region, sk, torch, fake,
                                    grid)

        # flush after the replay: obsolete deletes the replayed segments
        before = fake.keys(wal_prefix)
        t = time.perf_counter()
        wait_admin(engine, qe.execute_one("ADMIN flush_table('cpu')"))
        steps["flush_after_replay_s"] = time.perf_counter() - t
        after = fake.keys(wal_prefix)
        log("(j) flush after the replay: " + json.dumps({
            "wal_objects_before": len(before), "wal_objects_after":
            len(after), "seconds": steps["flush_after_replay_s"],
            "sst_files": len(region.files)}))
        check(len(before) == puts and not after,
              f"(j) obsolete: {len(before)} WAL objects before the flush "
              f"for {puts} puts ({before}), {len(after)} after")
        with partial_cache(False):
            copies = copy_phase(qe, engine, sk, torch, grid, host_names,
                                work)
        engine.close()
        engines.remove(engine)
        cli_runs = export_import_phase(grid, host_names, work)
        check(fake.bad_signatures == 0,
              f"(j) {fake.bad_signatures} requests failed SigV4")
        total = time.perf_counter() - t_phase
        summary = {"seconds": total, "steps": {**steps, **copies["steps"]},
                   "rows": points * HOSTS, "depth_hours": STORE_HOURS,
                   "depth_cut": "4 h of the headline's 12 h, by the run's "
                   "time limit",
                   "bucket_objects": len(fake.keys("")),
                   "bucket_bytes": fake.stored_bytes(),
                   "s3_requests_total": fake.snapshot()["requests"],
                   "card": card}
        log("(j) object storage and COPY: " + json.dumps(summary))
        return {"queries": queries, "copy": copies, "replay": replay,
                "cli": cli_runs, "summary": summary}
    finally:
        for e in engines:
            e.close()
        fake.close()
        shutil.rmtree(work, ignore_errors=True)


# ---- (k) the lint plane on the card's machine --------------------------------

#: the lockdep server's `cpu` table: hosts and the points loaded before the
#: traffic (10 minutes at 10 s); double_groupby_all's 12 h window then has
#: 12 x 400 = 4,800 groups, past K2's 4,096-segment route envelope, so it
#: takes K1 (dense_prepared), and cpu_max_all_8 takes K2
LOCKDEP_HOSTS = 400
LOCKDEP_LOAD_POINTS = 60
#: seconds of concurrent traffic, and its clients (one a role): "flight"
#: runs double_groupby_all over Flight (do_get) and writes its own points
#: through do_put, so Flight's threads and locks run under the lockdep
#: 30 s before phase (l); the 20 s cut pays for phase (l)
LOCKDEP_SECONDS = 10.0
LOCKDEP_ROLES = ("double_groupby_all", "flight", "cpu_max_all_8",
                 "cpu_max_all_8", "lp", "lp", "admin", "flow")


def lockdep_flight_table(p0: int, p1: int, rng):
    """Points [p0, p1) of every lockdep host as a Flight column table."""
    from greptimedb_tpu_torch.datasource import TextColumn, TextTable

    n = (p1 - p0) * LOCKDEP_HOSTS
    cols = {"hostname": TextColumn.of_codes(
                np.tile(np.arange(LOCKDEP_HOSTS, dtype=np.int32), p1 - p0),
                np.asarray([f"host_{i}" for i in range(LOCKDEP_HOSTS)],
                           dtype=object)),
            "ts": TextColumn(np.repeat(T0_MS + np.arange(p0, p1,
                                                         dtype=np.int64)
                                       * STEP_S * 1000, LOCKDEP_HOSTS),
                             None, "timestamp[ms]")}
    for f in FIELDS:
        cols[f] = TextColumn(np.round(rng.uniform(0, 100, n), 3), None,
                             "double")
    return TextTable(["hostname", "ts", *FIELDS], cols, n)


def lockdep_lp_body(p0: int, p1: int, rng) -> bytes:
    """Line protocol of `cpu` for points [p0, p1) of every lockdep host
    (ms timestamps), time-major."""
    hosts = np.tile(np.arange(LOCKDEP_HOSTS), p1 - p0)
    ts = np.repeat(T0_MS + np.arange(p0, p1, dtype=np.int64) * STEP_S
                   * 1000, LOCKDEP_HOSTS)
    vals = np.round(rng.uniform(0, 100, (len(FIELDS), len(hosts))), 3)
    fmt = "cpu,hostname=host_{} " + ",".join(f"{f}={{}}" for f in FIELDS) \
        + " {}"
    return "\n".join(map(fmt.format, hosts.tolist(),
                         *(v.tolist() for v in vals),
                         ts.tolist())).encode()


def lint_start() -> subprocess.Popen:
    """`python -m greptimedb_tpu_torch.lint --all --json --verbose` in a
    process of its own (it runs beside the lockdep server's traffic)."""
    return subprocess.Popen(
        [sys.executable, "-m", "greptimedb_tpu_torch.lint", "--all",
         "--json", "--verbose"], cwd=HERE,
        env=dict(os.environ, PYTHONPATH=HERE), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def lint_result(proc: subprocess.Popen, t_start: float) -> dict:
    """The lint's exit 0 and no unallowed finding; the allowed ones
    counted by checker."""
    stdout, stderr = proc.communicate(timeout=300)
    seconds = time.perf_counter() - t_start
    check(proc.returncode == 0,
          f"(k) the lint exited {proc.returncode}: {stdout[-3000:]} "
          f"{stderr[-2000:]}")
    found = json.loads(stdout[stdout.index("["):])
    by: dict = {}
    for f in found:
        by[f["checker"]] = by.get(f["checker"], 0) + 1
    out = {"seconds": seconds,
           "unallowed": sum(1 for f in found if not f["allowed"]),
           "allowed": sum(1 for f in found if f["allowed"]),
           "allowed_by_checker": dict(sorted(by.items()))}
    check(out["unallowed"] == 0, f"(k) lint: {json.dumps(out)}")
    return out


def lockdep_server_run(work: str) -> dict:
    """`standalone start` under the port's runtime lockdep, driven by
    a client a LOCKDEP_ROLES role for LOCKDEP_SECONDS (SQL through K1 and K2,
    line-protocol writes, ADMIN flush / compact, a flow's ticks), then
    SIGTERM: the server leaves its lock graph in the dump directory and
    this process merges it (assert_acyclic_merged)."""
    import http.client
    import signal
    import threading
    import urllib.parse

    from greptimedb_tpu_torch.lint import lockdep

    home = os.path.join(work, "home")
    dump = os.path.join(work, "lockdep")
    cmd = [sys.executable, "-m", "greptimedb_tpu_torch", "standalone",
           "start", "--data-home", home, "--http-addr", "127.0.0.1:0"]
    if DEVICE is not None:
        cmd += ["--device", DEVICE]
    env = dict(os.environ, PYTHONPATH=HERE, GTPU_TORCH_LOCKDEP="1",
               GTPU_TORCH_LOCKDEP_DIR=dump,
               GREPTIMEDB_TPU__GRPC__ENABLE="true",
               GREPTIMEDB_TPU__GRPC__ADDR="127.0.0.1:0")
    stderr_path = os.path.join(work, "server.stderr")
    t_start = time.perf_counter()
    with open(stderr_path, "w") as err:
        proc = subprocess.Popen(cmd, cwd=HERE, env=env,
                                stdout=subprocess.PIPE, stderr=err)

    def server_err() -> str:
        with open(stderr_path, errors="replace") as f:
            return f.read()[-3000:]

    rng = np.random.default_rng(SEED)
    queries = tsbs_queries()
    calls: dict = {}
    errors: list = []
    try:
        line, fline = read_ready(proc, 2)
        check("listening on http://127.0.0.1:" in line
              and fline.startswith("flight on grpc://127.0.0.1:"),
              f"(k) the lockdep server did not start: {line!r} {fline!r} "
              f"{server_err()}")
        port = int(line.rsplit(":", 1)[1])
        flight_addr = "127.0.0.1:" + fline.rsplit(":", 1)[1].strip()
        start_s = time.perf_counter() - t_start

        def request(conn, method, path, body=None, what=""):
            headers = {"Content-Type": "application/x-www-form-urlencoded"}
            conn.request(method, path, body=body, headers=headers)
            resp = conn.getresponse()
            data = resp.read()
            if resp.status >= 300:
                raise CheckFailed(f"(k) {what or path}: {resp.status} "
                                  f"{data[:300]!r}")
            calls[what] = calls.get(what, 0) + 1
            return data

        def sql(conn, text, what):
            return request(conn, "POST", "/v1/sql", urllib.parse.urlencode(
                {"sql": text}).encode(), what)

        setup = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        try:
            sql(setup, cpu_ddl(), "ddl")
            request(setup, "POST", "/v1/influxdb/write?precision=ms",
                    lockdep_lp_body(0, LOCKDEP_LOAD_POINTS, rng), "load")
            sql(setup, FLOW_SQL, "create flow")
        finally:
            setup.close()

        points = [LOCKDEP_LOAD_POINTS]
        lock = threading.Lock()
        stop_at = time.monotonic() + LOCKDEP_SECONDS

        def flight_client(crng):
            from greptimedb_tpu_torch.servers import flight

            fc = flight.FlightQueryClient(flight_addr)
            try:
                k = 0
                while time.monotonic() < stop_at:
                    if k % 2 == 0:
                        res = fc.sql(queries["double_groupby_all"][0])
                        check(res.num_rows > 0, "(k) flight do_get: empty")
                        what = "flight do_get"
                    else:
                        with lock:
                            p0 = points[0]
                            points[0] += 6
                        n = fc.insert("cpu", lockdep_flight_table(
                            p0, p0 + 6, crng))
                        check(n == 6 * LOCKDEP_HOSTS,
                              f"(k) flight do_put acked {n}")
                        what = "flight do_put"
                    with lock:
                        calls[what] = calls.get(what, 0) + 1
                    k += 1
            finally:
                fc.close()

        def client(i: int, role: str):
            crng = np.random.default_rng([SEED, i])
            if role == "flight":
                try:
                    flight_client(crng)
                except Exception as e:  # noqa: BLE001 — reported, fails
                    errors.append(f"{role}: {type(e).__name__}: {e}")
                return
            conn = http.client.HTTPConnection("127.0.0.1", port,
                                              timeout=300)
            try:
                k = 0
                while time.monotonic() < stop_at:
                    if role in queries:
                        sql(conn, queries[role][0], role)
                    elif role == "lp":
                        with lock:
                            p0 = points[0]
                            points[0] += 6
                        request(conn, "POST",
                                "/v1/influxdb/write?precision=ms",
                                lockdep_lp_body(p0, p0 + 6, crng),
                                "lp write")
                    elif role == "admin":
                        op = "flush_table" if k % 2 == 0 else \
                            "compact_table"
                        sql(conn, f"ADMIN {op}('cpu')", f"ADMIN {op}")
                        time.sleep(1.0)
                    else:
                        sql(conn, "ADMIN flush_flow('cpu_hourly')",
                            "flow tick")
                        time.sleep(0.5)
                    k += 1
            except Exception as e:  # noqa: BLE001 — reported, then fails
                errors.append(f"{role}: {type(e).__name__}: {e}")
            finally:
                conn.close()

        threads = [threading.Thread(target=client, args=(i, r),
                                    name=f"lockdep-{r}-{i}")
                   for i, r in enumerate(LOCKDEP_ROLES)]
        t = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(LOCKDEP_SECONDS + 300)
        drive_s = time.perf_counter() - t
        check(not any(th.is_alive() for th in threads),
              "(k) a lockdep client did not finish")
        check(calls.get("flight do_get", 0) > 0
              and calls.get("flight do_put", 0) > 0,
              f"(k) the Flight client's calls: {calls}")
        check(not errors, f"(k) lockdep traffic failed: {errors[:3]} "
              f"{server_err()}")
        launches = kernel_launches(scrape(port))
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        check(rc == 0, f"(k) the lockdep server exited {rc}: "
              f"{server_err()}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    try:
        rep = lockdep.assert_acyclic_merged(dump)
    except lockdep.LockOrderViolation as e:
        raise CheckFailed(f"(k) lock order: {e}") from None
    sites = {s for e in rep["edges"] for s in e}
    port_edges = [e for e in rep["edges"]
                  if all(s.startswith("greptimedb_tpu_torch") for s in e)]
    check(rep["processes"] >= 2 and port_edges,
          f"(k) the server left no lock graph: {rep['processes']} "
          f"processes, {len(rep['edges'])} edges")
    if DEVICE is None:
        check(launches["segment_sum"] > 0
              and launches["fused_segment_agg"] > 0,
              f"(k) the lockdep server's launches: {launches}")
    return {"start_s": start_s, "drive_s": drive_s, "clients": len(threads),
            "requests": calls, "rows_written": points[0] * LOCKDEP_HOSTS,
            "locks": len(sites), "edges": len(rep["edges"]),
            "port_edges": len(port_edges),
            "violations": len(rep["violations"]),
            "cycle": rep["cycle"], "processes": rep["processes"],
            "k1_launches": launches["segment_sum"],
            "k2_launches": launches["fused_segment_agg"],
            "wall_s": time.perf_counter() - t_start}


def lint_phase(card: str) -> dict:
    """Phase (k): the port's lint plane on the card's machine (no jax, no
    pyarrow): the static checkers report no unallowed finding (run beside
    the server), and a standalone server under the runtime lockdep
    serves mixed concurrent traffic with an acyclic lock order."""
    import shutil
    import tempfile

    t = time.perf_counter()
    lint_proc = lint_start()
    work = tempfile.mkdtemp(prefix="chip_smoke_lockdep_")
    try:
        server = lockdep_server_run(work)
    except BaseException:
        lint_proc.kill()
        lint_proc.communicate()
        raise
    finally:
        shutil.rmtree(work, ignore_errors=True)
    lint = lint_result(lint_proc, t)
    log("(k) lint (beside the server's traffic): " + json.dumps(lint))
    log("(k) lockdep server: " + json.dumps(server))
    out = {"lint": lint, "server": server,
           "seconds": time.perf_counter() - t, "card": card}
    log("(k) the lint plane: " + json.dumps(
        {"seconds": out["seconds"], "unallowed": lint["unallowed"],
         "violations": server["violations"], "card": card}))
    return out


# ---- (l) the in-process cluster: cpu over three datanodes --------------------

#: phase (l)'s range rule over hostname: its sort order puts host_0,
#: host_1 and host_10..host_1999 first, so the three regions hold 1,112 /
#: 1,111 / 1,777 hosts
CLUSTER_PARTITION = (
    "PARTITION ON COLUMNS (hostname) (hostname < 'host_2', "
    "hostname >= 'host_2' AND hostname < 'host_3', hostname >= 'host_3')")
#: warm runs a statement (their p50 is printed)
CLUSTER_WARM_RUNS = 5
#: the statements of phase (l): name -> (SQL, the cluster frontend's
#: last_path); lastpoint is all-`last`, so its fragment carries the
#: newest-first pruning hint
CLUSTER_QUERIES = (
    "double_groupby_all (1 h)", "double_groupby_all (10 min)",
    "cpu_max_all_8", "single_groupby_1_1_1", "groupby_orderby_limit",
    "lastpoint", "high_cpu_all")


def cluster_ddl() -> str:
    """bench.py's `cpu` table, partitioned by CLUSTER_PARTITION."""
    return cpu_ddl().replace(") WITH (append_mode",
                             f") {CLUSTER_PARTITION} WITH (append_mode")


def cluster_dga_sql(bin_: str) -> str:
    avg_list = ", ".join(f"avg({f})" for f in FIELDS)
    return (f"SELECT date_bin(INTERVAL '{bin_}', ts) AS hour, hostname, "
            f"{avg_list} FROM cpu WHERE ts >= {T0_MS} "
            f"AND ts < {T0_MS + HOURS * 3600 * 1000} "
            "GROUP BY hour, hostname ORDER BY hour, hostname")


def cluster_queries() -> dict:
    q = tsbs_queries()
    last_list = ", ".join(f"last({f})" for f in FIELDS)
    return {
        "double_groupby_all (1 h)": (cluster_dga_sql("1 hour"), "pushdown"),
        "double_groupby_all (10 min)": (cluster_dga_sql("10 minutes"),
                                        "pushdown"),
        "cpu_max_all_8": (q["cpu_max_all_8"][0], "pushdown"),
        "single_groupby_1_1_1": (q["single_groupby_1_1_1"][0], "pushdown"),
        "groupby_orderby_limit": (q["groupby_orderby_limit"][0],
                                  "pushdown"),
        "lastpoint": (f"SELECT hostname, {last_list} FROM cpu "
                      "GROUP BY hostname", "lastfrag+pushdown"),
        "high_cpu_all": (q["high_cpu_all"][0], "rows_pushdown"),
    }


def cluster_batch(info, host_names):
    """bench.py's generator at HOSTS x 1 h (seed SERVE_SEED, the draws
    put_points makes) as one RecordBatch, and its [points, hosts] grid."""
    from greptimedb_tpu_torch.datatypes import DictVector, RecordBatch

    points = 3600 // STEP_S
    n = points * HOSTS
    rng = np.random.default_rng(SERVE_SEED)
    cols = {"hostname": DictVector(np.tile(np.arange(HOSTS, dtype=np.int32),
                                           points), host_names),
            "ts": np.repeat(T0_MS + np.arange(points, dtype=np.int64)
                            * STEP_S * 1000, HOSTS)}
    for f in FIELDS:
        cols[f] = rng.uniform(0.0, 100.0, n)
    grid = {f: cols[f].reshape(points, HOSTS) for f in FIELDS}
    return RecordBatch(info.schema, cols), grid


def check_cluster(name, res, grid, exact) -> None:
    """One phase (l) statement against float64 numpy over the hour's
    `grid`: avg to rtol 1e-5, max, last, keys and rows exactly (`exact`
    maps the float64 oracle to what the route's dtype gives: itself on
    the cluster's float64 fragments, f32_exact on an f32 standalone)."""
    per_hour = 3600 // STEP_S
    cols = {n: np.asarray(c) for n, c in zip(res.names, res.columns)}
    order = np.argsort(np.asarray([f"host_{i}" for i in range(HOSTS)]),
                       kind="stable")
    if name.startswith("double_groupby_all"):
        per = per_hour if "1 h" in name else 60
        bins = per_hour // per
        check(np.array_equal(cols["hour"], T0_MS + np.repeat(
            np.arange(bins), HOSTS) * per * STEP_S * 1000), name + " keys")
        check(np.array_equal(host_index(cols["hostname"]),
                             np.tile(order, bins)), name + " hostnames")
        for f in FIELDS:
            want = grid[f].reshape(bins, per, HOSTS).mean(axis=1)[
                :, order].reshape(-1)
            got = cols[f"avg({f})"].astype(np.float64)
            check(np.allclose(got, want, rtol=1e-5, atol=0),
                  f"{name} avg({f})")
    elif name == "cpu_max_all_8":
        check(np.array_equal(cols["hour"], [T0_MS]), name + " keys")
        for f in FIELDS:
            check(np.array_equal(cols[f"max({f})"].astype(np.float64),
                                 exact(grid[f][:, :8].max(keepdims=True)
                                       .reshape(1))), f"{name} max({f})")
    elif name == "single_groupby_1_1_1":
        want = grid["usage_user"][:, 0].reshape(60, 6).max(axis=1)
        check(np.array_equal(cols["minute"], T0_MS + np.arange(60) * 60_000)
              and np.array_equal(cols["max(usage_user)"].astype(np.float64),
                                 exact(want)), name)
    elif name == "groupby_orderby_limit":
        minutes = np.arange(59, 54, -1)
        want = np.asarray([grid["usage_user"][m * 6:(m + 1) * 6].max()
                           for m in minutes])
        check(np.array_equal(cols["minute"], T0_MS + minutes * 60_000)
              and np.array_equal(cols["max(usage_user)"].astype(np.float64),
                                 exact(want)), name)
    elif name == "lastpoint":
        hosts = host_index(cols["hostname"])
        check(np.array_equal(np.sort(hosts), np.arange(HOSTS)),
              name + " hostnames")
        for f, col in zip(FIELDS, res.names[1:]):
            check(np.array_equal(cols[col].astype(np.float64),
                                 exact(grid[f][-1, hosts])), f"{name} {f}")
    else:  # high_cpu_all
        hit = grid["usage_user"] > 90.0
        want = np.flatnonzero(hit.reshape(-1))
        pts = (cols["ts"].astype(np.int64) - T0_MS) // (STEP_S * 1000)
        got = pts * HOSTS + host_index(cols["hostname"])
        srt = np.argsort(got, kind="stable")
        check(np.array_equal(got[srt], want), f"{name}: {len(got)} rows")
        p, h = np.divmod(want, HOSTS)
        for f in FIELDS:
            check(np.array_equal(cols[f].astype(np.float64)[srt],
                                 grid[f][p, h]), f"{name} {f}")


def leader_of(cluster, rid: int) -> str:
    """The datanode the metasrv's route table names for region `rid`."""
    return cluster.metasrv.routes.get(str(rid >> 32)).region(rid) \
        .leader_node


def _nbytes(arr) -> int:
    arr = np.asarray(arr)
    if arr.dtype == object:
        return sum(len(str(x)) for x in arr.tolist())
    return int(arr.nbytes)


def part_bytes(part) -> int:
    """Bytes of one fragment's output: partial planes and keys, a vmapped
    batch's JSON, or the candidate / filtered columns."""
    if part is None:
        return 0
    if "members" in part or "vmap_ineligible" in part:
        return len(json.dumps(part, default=lambda x: x.tolist()
                              if hasattr(x, "tolist") else str(x)))
    if "planes" in part:
        return sum(_nbytes(k) for k in part["keys"]) + sum(
            int(v.nbytes) for v in part["planes"].values())
    return sum(_nbytes(v) for v in part["cols"].values())


class FragmentMeter:
    """Counts, on a cluster, the bytes its fragments return to the
    frontend, the fragments that return partial planes (each one K2
    launch on its region's datanode) and the rows its datanodes' region
    scans read."""

    def __init__(self, cluster):
        self.bytes = self.rows = self.fragments = self.planes = 0
        router = cluster.router
        inner = router.execute_fragment

        def execute_fragment(rid, frag):
            out = inner(rid, frag)
            self.bytes += part_bytes(out)
            self.fragments += 1
            # partial planes, or a vmapped batch with a member here: one
            # K2 launch on the region's datanode (cold)
            self.planes += out is not None and (
                "planes" in out or any(out.get("members") or ()))
            return out

        router.execute_fragment = execute_fragment
        for dn in cluster.datanodes.values():
            # a datanode process's scans are its own: counted only in
            # process
            if hasattr(dn, "engine"):
                for attr in ("scan", "scan_last"):
                    self._wrap(dn.engine, attr)

    def _wrap(self, engine, attr):
        inner = getattr(engine, attr)

        def counted(*a, **k):
            out = inner(*a, **k)
            self.rows += 0 if out is None else int(out.num_rows)
            return out

        setattr(engine, attr, counted)

    def reset(self):
        self.bytes = self.rows = self.fragments = self.planes = 0


def cluster_statement(c, meter, sk, torch, name, sql, want_path, grid,
                      exact, runs=CLUSTER_WARM_RUNS) -> tuple:
    """One statement through Cluster.sql: cold (its K1 / K2 launches,
    fragment bytes and region rows scanned), then warm p50 of `runs`;
    the answer against numpy. Returns (report, the cold result)."""
    meter.reset()
    zero_launches(sk)
    res, cold_ms = timed_query(c.frontend, sql, torch)
    k1, k2 = launches(sk)
    path = c.frontend.executor.last_path
    check(path == want_path, f"cluster {name}: last_path {path}")
    check(k1 == 0, f"cluster {name}: K1 launched {k1} times")
    if grid is not None:
        check_cluster(name, res, grid, exact)
    check(k2 == meter.planes,
          f"cluster {name}: {k2} K2 launches for {meter.planes} fragments "
          "that returned partial planes")
    rep = {"last_path": path, "rows": res.num_rows, "cold_ms": cold_ms,
           "k1_launches": k1, "k2_launches": k2,
           "fragments": meter.fragments, "planes": meter.planes,
           "fragment_bytes": meter.bytes,
           "region_rows_scanned": meter.rows}
    warm = []
    for _ in range(runs):
        warm.append(timed_query(c.frontend, sql, torch)[1])
    rep["warm_p50_ms"] = float(np.median(warm)) if warm else None
    return rep, res


def capture_k2(sk, fn):
    """Run `fn` with K2's wrapper spied: the largest call's inputs (by
    rows) and flags come back beside `fn`'s result; every launch still
    counts on the wrapper."""
    real = sk.fused_segment_agg
    seen: dict = {}

    def spy(vals, ids, num_segments, want_min=False, want_max=False,
            want_sumsq=False):
        if vals.shape[0] > seen.get("n", -1):
            seen.update(n=vals.shape[0], vals=vals, ids=ids,
                        g=num_segments,
                        want=(bool(want_min), bool(want_max),
                              bool(want_sumsq)))
        return real(vals, ids, num_segments, want_min, want_max,
                    want_sumsq)

    spy.launches = real.launches
    sk.fused_segment_agg = spy
    try:
        out = fn()
    finally:
        sk.fused_segment_agg = real
        real.launches = spy.launches
    return out, seen


def same_rows(a, b, what) -> None:
    """Two answers of the same statement: names and keys exactly, floats
    to rtol 1e-12 (float64 sums may reassociate between runs)."""
    check(list(a.names) == list(b.names) and a.num_rows == b.num_rows,
          f"{what}: shapes differ")
    def floats(v):
        return np.asarray([np.nan if e is None else e for e in v],
                          dtype=np.float64) if v.dtype == object else \
            v.astype(np.float64)

    for x, y in zip(a.columns, b.columns):
        x, y = np.asarray(x), np.asarray(y)
        if "f" in (x.dtype.kind, y.dtype.kind):
            # a NULL is None in an object column, NaN in a float one
            check(np.allclose(floats(x), floats(y), rtol=1e-12, atol=0,
                              equal_nan=True), f"{what}: values differ")
        else:
            check(np.array_equal(x.astype(str), y.astype(str)),
                  f"{what}: keys differ")


#: the window statement's span: usage_user's step between successive
#: points of every host over the hour's first WINDOW_MINUTES
WINDOW_MINUTES = 10
#: the vmapped batch's members: single_groupby_1_1_1's dash, one host
#: each, spread over the three regions
DASH_HOSTS = (0, 1, 10, 2, 20, 2500, 3, 3999)
#: the deploy leg's heartbeat interval, seconds (the CLI roles')
DEPLOY_HEARTBEAT_S = 0.25
#: the deploy leg's flownode: its tick interval, and the flow it ticks
DEPLOY_FLOW_TICK_S = 0.5
DEPLOY_FLOW_SQL = (
    "CREATE FLOW lp_hourly_flow SINK TO lp_hourly AS SELECT hostname, "
    "date_bin(INTERVAL '1 hour', ts) AS hour, avg(usage_user) AS a, "
    "count(*) AS c FROM cpu_lp GROUP BY hostname, hour")
#: the deploy leg's depth: the hour's first DEPLOY_HOSTS hosts (a cut
#: from HOSTS: the leg's line-protocol write and its seven process
#: spawns cost the script's time limit what phase (l) may add)
DEPLOY_HOSTS = 1000


def window_sql() -> str:
    return ("SELECT hostname, ts, usage_user - lag(usage_user) OVER "
            "(PARTITION BY hostname ORDER BY ts) AS d FROM cpu WHERE ts >= "
            f"{T0_MS} AND ts < {T0_MS + WINDOW_MINUTES * 60_000} "
            "ORDER BY hostname, ts")


def dash_sql(h: int) -> str:
    """single_groupby_1_1_1 of one host, in the batcher's dash form (the
    selector tag out of the keys, no ORDER BY)."""
    return ("SELECT date_bin(INTERVAL '1 minute', ts) AS minute, "
            "max(usage_user) FROM cpu WHERE hostname = "
            f"'host_{h}' AND ts >= {T0_MS} AND ts < {T0_MS + 3600 * 1000} "
            "GROUP BY minute")


def check_window(res, grid, what) -> None:
    """The window statement against numpy: every host's rows in hostname
    order, d the step from the point before (NULL on each host's
    first)."""
    pts = WINDOW_MINUTES * 60 // STEP_S
    check(res.num_rows == HOSTS * pts, f"{what}: {res.num_rows} rows")
    cols = {n: np.asarray(c) for n, c in zip(res.names, res.columns)}
    order = np.argsort(np.asarray([f"host_{i}" for i in range(HOSTS)]),
                       kind="stable")
    check(np.array_equal(host_index(cols["hostname"]),
                         np.repeat(order, pts)), f"{what}: hostnames")
    check(np.array_equal(cols["ts"].astype(np.int64), np.tile(
        T0_MS + np.arange(pts) * STEP_S * 1000, HOSTS)), f"{what}: ts")
    u = grid["usage_user"][:pts, order]
    want = np.vstack([np.full((1, HOSTS), np.nan),
                      u[1:] - u[:-1]]).T.reshape(-1)
    got = np.asarray([np.nan if v is None else v for v in cols["d"]],
                     dtype=np.float64)
    check(np.array_equal(got, want, equal_nan=True)
          and int(np.isnan(got).sum()) == HOSTS, f"{what}: d")


def check_dash(results: dict, grid, what) -> None:
    """Each dash member against numpy: its host's minute maxima."""
    for h, res in results.items():
        cols = {n: np.asarray(c) for n, c in zip(res.names, res.columns)}
        order = np.argsort(cols["minute"].astype(np.int64))
        want = grid["usage_user"][:, h].reshape(60, 6).max(axis=1)
        check(np.array_equal(cols["minute"].astype(np.int64)[order],
                             T0_MS + np.arange(60) * 60_000)
              and np.array_equal(cols["max(usage_user)"].astype(
                  np.float64)[order], want), f"{what}: host_{h}")


def dash_batch(qe, torch):
    """The DASH_HOSTS members as ONE batch group through run_vmapped (as
    tests/test_cluster_pushdown.py::TestVmappedFragments drives it):
    {host: result}, the call's ms, the route."""
    from greptimedb_tpu_torch.concurrency import batcher
    from greptimedb_tpu_torch.query.vmapped import run_vmapped
    from greptimedb_tpu_torch.session import QueryContext
    from greptimedb_tpu_torch.sql import parse_sql

    info = qe._table("cpu", QueryContext())
    sels = [parse_sql(dash_sql(h))[0] for h in DASH_HOSTS]
    shapes = [batcher.analyze(sel, info) for sel in sels]
    check(all(sh is not None for sh in shapes)
          and len({sh.masked for sh in shapes}) == 1,
          "dash batch: the members are not one batch group")
    order: list = []
    for sh in shapes:
        if sh.values not in order:
            order.append(sh.values)
    sync(torch)
    t = time.perf_counter()
    out = run_vmapped(qe.executor, sels[0], info, shapes[0].params, order)
    ms = (time.perf_counter() - t) * 1e3
    return ({h: out[order.index(sh.values)]
             for h, sh in zip(DASH_HOSTS, shapes)}, ms,
            qe.executor.last_path)


def datanode_reports(tid: str) -> dict:
    """What the datanode processes reported on the spans piggybacked on
    the statement's Flight responses: per node, the K1 / K2 launches of
    its region_frag spans and its K2 calls (rows, fields, segments,
    device ms as the datanode timed them)."""
    from greptimedb_tpu_torch.utils import tracing

    out: dict = {}
    for sp in tracing.spans_for(tid):
        if sp.node is None:
            continue
        node = out.setdefault(sp.node, {"k1_launches": 0, "k2_launches": 0,
                                        "k2_calls": []})
        if sp.name == "region_frag":
            node["k1_launches"] += int(sp.attrs.get("k1_launches", 0))
            node["k2_launches"] += int(sp.attrs.get("k2_launches", 0))
        elif sp.name == "k2":
            node["k2_calls"].append({k: sp.attrs.get(k) for k in (
                "rows", "fields", "segments", "launches", "device_ms")})
    return out


def gpu_apps() -> dict:
    """pid -> the card memory it holds, as nvidia-smi lists compute
    apps."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"], capture_output=True, text=True)
    apps = {}
    for line in smi.stdout.strip().splitlines():
        pid, _, mem = line.partition(",")
        if pid.strip().isdigit():
            apps[int(pid)] = mem.strip()
    return apps


def gpu_used_mib() -> int:
    """The card's used memory, MiB (nvidia-smi)."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used",
         "--format=csv,noheader,nounits"], capture_output=True, text=True)
    return int(smi.stdout.strip().splitlines()[0])


#: the least card memory a datanode process's CUDA context holds, MiB
CHILD_CONTEXT_MIB = 200


def children_on_card(pids: dict, used_before: int, what: str) -> dict:
    """Each child's card memory as nvidia-smi lists its compute apps, and
    the card's used memory before and after the children came up. In a
    container whose process ids nvidia-smi does not see (it lists another
    pid namespace's), the growth of the card's memory by at least one
    CUDA context a child stands for the per-process list."""
    apps = gpu_apps()
    used = gpu_used_mib()
    rep = {"compute_apps": apps, "used_mib_before": used_before,
           "used_mib_after": used,
           "child_memory": {n: apps.get(p) for n, p in pids.items()}}
    on_card = all(p in apps for p in pids.values()) or \
        used - used_before >= CHILD_CONTEXT_MIB * len(pids)
    check(on_card, f"{what}: the children are not on the card ({rep})")
    return rep


def proc_statement(pc, meter, sk, torch, name, run, answer, check_fn,
                   want_path) -> tuple:
    """One statement on the process cluster under a trace of its own:
    cold and warm ms, the route, the answer against the in-process one
    (rtol 1e-12) and numpy, and the K1 / K2 launches the datanodes
    report, held to the fragments that returned planes (a hedge's
    duplicate may add or hide one a hedge fired)."""
    from greptimedb_tpu_torch.utils import tracing
    from greptimedb_tpu_torch.utils.metrics import HEDGE_EVENTS

    meter.reset()
    zero_launches(sk)
    fired0 = HEDGE_EVENTS.get(event="fired")
    tid = tracing.new_trace_id()
    res, cold_ms, path = run(tid)
    fired = int(HEDGE_EVENTS.get(event="fired") - fired0)
    reports = datanode_reports(tid)
    k1 = sum(r["k1_launches"] for r in reports.values())
    k2 = sum(r["k2_launches"] for r in reports.values())
    pk1, pk2 = launches(sk)
    check(path == want_path, f"process {name}: last_path {path}")
    check(k1 == 0 and pk1 == 0 and pk2 == 0,
          f"process {name}: K1 {k1} on the datanodes, K1 / K2 {pk1} / "
          f"{pk2} in the frontend")
    # off the card the children run the plain versions: no launch
    check(DEVICE is not None or abs(k2 - meter.planes) <= fired,
          f"process {name}: the datanodes report {k2} K2 launches for "
          f"{meter.planes} plane fragments and {fired} hedges")
    if answer is not None:
        if isinstance(res, dict):
            for h, r in res.items():
                same_rows(r, answer[h], f"process {name} host_{h}")
        else:
            same_rows(res, answer, f"process {name}")
    check_fn(res)
    rep = {"last_path": path, "cold_ms": cold_ms, "planes": meter.planes,
           "fragments": meter.fragments, "fragment_bytes": meter.bytes,
           "hedges_fired": fired, "k1_launches": k1, "k2_launches": k2,
           "k2_by_datanode": {n: r["k2_launches"]
                              for n, r in sorted(reports.items())},
           "k2_calls": {n: r["k2_calls"]
                        for n, r in sorted(reports.items())}}
    if not isinstance(res, dict):
        rep["rows"] = res.num_rows
    # warm: the datanodes answer plane fragments from their fragment
    # caches
    rep["warm_ms"] = float(np.median([run(None)[1] for _ in range(2)]))
    return rep, res


def process_leg(sk, torch, lib, root, host_names, queries,
                answers) -> dict:
    """The cluster across processes: three datanode processes on the
    card (`ProcessCluster`), the hour through the scatter write (each
    region's slice over do_put into its process), a flush, the
    statements against the in-process answers and numpy with the K2
    launches the datanodes report, then a kill -9 failover with no
    acknowledged write lost."""
    from greptimedb_tpu_torch.cluster.process_cluster import ProcessCluster
    from greptimedb_tpu_torch.session import QueryContext
    from greptimedb_tpu_torch.utils import tracing
    from greptimedb_tpu_torch.utils.metrics import HEDGE_EVENTS

    t_leg = time.perf_counter()
    out: dict = {}
    hedges0 = {ev: HEDGE_EVENTS.get(event=ev)
               for ev in ("fired", "won", "lost", "budget_denied")}
    used0 = gpu_used_mib() if DEVICE is None else 0
    t = time.perf_counter()
    pc = ProcessCluster(os.path.join(root, "proc"), num_datanodes=3,
                        device=DEVICE)
    try:
        out["spawn"] = {
            "seconds": time.perf_counter() - t,
            "ready_s": {n: dn.ready_s for n, dn in pc.datanodes.items()},
            "pids": {n: dn.pid for n, dn in pc.datanodes.items()},
            "startup": {n: dn.stderr_tail().strip().splitlines()[-1:]
                        for n, dn in pc.datanodes.items()}}
        if DEVICE is None:
            out["spawn"]["gpu"] = children_on_card(
                out["spawn"]["pids"], used0, "process")
        log("cluster (l) process spawn: " + json.dumps(out["spawn"]))
        tick_ms = 0.0
        for _ in range(5):  # the failure detector's interval history
            pc.beat_all(tick_ms)
            tick_ms += 3000.0
        pc.sql(cluster_ddl())
        info = pc.catalog.table("public", "cpu")
        batch, grid = cluster_batch(info, host_names)
        t = time.perf_counter()
        n = pc.frontend._sharded_write(info, batch, delete=False)
        put_s = time.perf_counter() - t
        count = pc.sql("SELECT count(*) FROM cpu").rows()[0][0]
        nodes = [leader_of(pc, rid) for rid in info.region_ids]
        check(n == HOSTS * 360 and count == n and len(set(nodes)) == 3,
              f"process scatter: {n} rows, count(*) {count}, nodes {nodes}")
        pc.sql("ADMIN flush_table('cpu')")
        out["put"] = {"rows": n, "seconds": put_s, "rows_per_s": n / put_s,
                      "nodes": nodes}
        log("cluster (l) process put: " + json.dumps(out["put"]))
        meter = FragmentMeter(pc)
        fe = pc.frontend

        def sql_run(sql):
            def run(tid):
                # the statement's own trace: the datanodes' spans land
                # under it
                sync(torch)
                t = time.perf_counter()
                res = fe.execute_one(sql, QueryContext(trace_id=tid))
                sync(torch)
                return (res, (time.perf_counter() - t) * 1e3,
                        fe.executor.last_path)
            return run

        def dash_run(tid):
            tracing.set_trace(tid)
            try:
                return dash_batch(fe, torch)
            finally:
                tracing.restore_trace(None)

        stmts = {}
        for name in ("double_groupby_all (1 h)",
                     "double_groupby_all (10 min)", "cpu_max_all_8",
                     "lastpoint"):
            sql, path = queries[name]
            stmts[name] = (sql_run(sql), answers[name],
                           lambda r, nm=name: check_cluster(
                               nm, r, grid, lambda x: x), path)
        stmts["window (lag, 10 min)"] = (
            sql_run(window_sql()), answers["window (lag, 10 min)"],
            lambda r: check_window(r, grid, "process window"),
            "window_pushdown")
        stmts["dash batch (8 members)"] = (
            dash_run, answers["dash batch (8 members)"],
            lambda r: check_dash(r, grid, "process dash batch"),
            "vmapped_fragments")
        reports = {}
        out["answers"] = {}
        for name, (run, answer, check_fn, path) in stmts.items():
            rep, res = proc_statement(pc, meter, sk, torch, name, run,
                                      answer, check_fn, path)
            reports[name] = rep
            out["answers"][name] = res
            log(f"cluster (l) process {name}: " + json.dumps(rep))
        out["statements"] = reports
        out["k2_launches"] = sum(r["k2_launches"] for r in reports.values())
        out["k1_launches"] = sum(r["k1_launches"] for r in reports.values())
        # the datanodes' K2 at their own shapes: the largest region's
        # 10 min fragment and the dash batch's largest member gather,
        # each against its plain version on the same shape (synthetic
        # inputs in this process; the datanode's own device ms beside)
        out["k2_shapes"] = {}
        for key, name, want in (
                ("fragment", "double_groupby_all (10 min)",
                 (False, False, False)),
                ("vmapped", "dash batch (8 members)", (False, True, False))):
            calls = [c for cs in reports[name]["k2_calls"].values()
                     for c in cs]
            big = max(calls, key=lambda c: c["rows"])
            case = {"datanode_device_ms": big["device_ms"],
                    "datanode_calls": len(calls), "shape": [big["rows"],
                                                            big["fields"]],
                    "G": big["segments"] + 1}
            if lib is not None:
                gen = torch.Generator(device="cuda").manual_seed(SEED)
                vals = torch.rand((big["rows"], big["fields"]),
                                  dtype=torch.float64, device="cuda",
                                  generator=gen) * 100.0
                ids = torch.randint(0, big["segments"], (big["rows"],),
                                    dtype=torch.int32, device="cuda",
                                    generator=gen)
                case.update(k2_case(sk, lib, torch, vals, ids,
                                    big["segments"] + 1, want, key,
                                    f"the datanode's {name}"))
            out["k2_shapes"][key] = case
            log(f"cluster (l) process K2 {key} shape: " + json.dumps(
                {k: case.get(k) for k in ("shape", "G",
                                          "datanode_device_ms", "ms",
                                          "plain_ms", "bound_ms")}))
        # ---- kill -9 the largest region's process, no acked row lost --
        extra, _g = cluster_batch(info, host_names)
        extra = extra.take(np.arange(HOSTS))  # one more 10 s slice
        extra.columns["ts"] = extra.columns["ts"] + 3600 * 1000
        last = {f: np.asarray(extra.columns[f], dtype=np.float64)
                for f in FIELDS}
        acked = pc.frontend._sharded_write(info, extra, delete=False)
        check(acked == HOSTS, f"process: {acked} extra rows acknowledged")
        rid2 = info.region_ids[2]
        victim = leader_of(pc, rid2)
        victim_pid = pc.datanodes[victim].pid
        t = time.perf_counter()
        pc.kill_datanode(victim)
        ticks = 0
        while True:
            pc.beat_all(tick_ms)
            ticks += 1
            if pc.tick(tick_ms):
                break
            check(ticks < 200, "process failover: no failover started")
            tick_ms += 3000.0
        pc.beat_all(tick_ms)  # delivers OpenRegion to the survivor
        new = leader_of(pc, rid2)
        replayed = pc.datanodes[new].remote.info(rid2)["replayed_entries"]
        count = pc.sql("SELECT count(*) FROM cpu").rows()[0][0]
        res = pc.sql(queries["double_groupby_all (1 h)"][0])
        fo_s = time.perf_counter() - t
        check(new != victim and replayed > 0 and count == HOSTS * 361,
              f"process failover: {victim} -> {new}, {replayed} replayed, "
              f"count(*) {count}")
        check(not alive(victim_pid), "process failover: the victim lives")
        cols = {c: np.asarray(v) for c, v in zip(res.names, res.columns)}
        order = np.argsort(np.asarray([f"host_{i}" for i in range(HOSTS)]),
                           kind="stable")
        check(res.num_rows == 2 * HOSTS and np.array_equal(
            cols["hour"].astype(np.int64),
            T0_MS + np.repeat([0, 3600 * 1000], HOSTS)),
            "process failover: double_groupby_all keys")
        for f in FIELDS:
            want = np.concatenate([grid[f].mean(axis=0)[order],
                                   last[f][order]])
            check(np.allclose(cols[f"avg({f})"].astype(np.float64), want,
                              rtol=1e-12, atol=0),
                  f"process failover: avg({f}) over every acked row")
        out["failover"] = {"victim": victim, "new_leader": new,
                           "ticks": ticks, "wal_entries_replayed": replayed,
                           "count": count, "seconds": fo_s}
        log("cluster (l) process failover: " + json.dumps(out["failover"]))
    finally:
        pids = [dn.pid for dn in pc.datanodes.values()]
        pc.close()
    check(not any(alive(p) for p in pids), "process: a child outlived close")
    out["hedges"] = {ev: int(HEDGE_EVENTS.get(event=ev) - v)
                     for ev, v in hedges0.items()}
    out["seconds"] = time.perf_counter() - t_leg
    log(f"cluster (l) process leg: {out['seconds']:.1f} s; hedges "
        + json.dumps(out["hedges"]))
    return out


def http_sql(port, sql, timeout=120) -> dict:
    import urllib.error
    import urllib.parse
    import urllib.request

    body = urllib.parse.urlencode({"sql": sql}).encode()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/v1/sql",
                                    data=body, timeout=timeout) as r:
            return json.loads(r.read())
    except urllib.error.HTTPError as e:
        return {"code": e.code, "error": e.read().decode(errors="replace")}


def http_rows_match(doc, res, what, hosts: int = 0) -> None:
    """An HTTP /v1/sql answer against a QueryResult: names, keys exactly,
    floats to rtol 1e-12; with `hosts`, against the result's rows of the
    first `hosts` hosts."""
    check(doc.get("code") == 0, f"{what}: {str(doc)[:300]}")
    rec = doc["output"][0]["records"]
    names = [c["name"] for c in rec["schema"]["column_schemas"]]
    keep = np.ones(res.num_rows, dtype=bool)
    if hosts and "hostname" in res.names:
        keep = host_index(np.asarray(
            res.columns[list(res.names).index("hostname")])) < hosts
    check(names == list(res.names) and len(rec["rows"]) == int(keep.sum()),
          f"{what}: shape {names} x {len(rec['rows'])}")
    for j, col in enumerate(res.columns):
        got = np.asarray([r[j] for r in rec["rows"]], dtype=object)
        want = np.asarray(col)[keep]
        if want.dtype.kind == "f":
            check(np.allclose(got.astype(np.float64), want, rtol=1e-12,
                              atol=0, equal_nan=True), f"{what}: {names[j]}")
        else:
            check(np.array_equal(got.astype(str), want.astype(str)),
                  f"{what}: {names[j]}")


def deploy_leg(root, host_names, grid, queries, answers) -> dict:
    """The CLI roles as tests/test_deploy.py runs them: `metasrv start`,
    three `datanode start` on the card and a `frontend start`, separate
    processes beating every DEPLOY_HEARTBEAT_S; the hour through the
    frontend's line-protocol route; double_groupby_all (1 h) and
    cpu_max_all_8 over /v1/sql against the process leg's answers; kill -9
    of a datanode, the metasrv's own ticker failing its region over
    (bounded at 60 s), the same rows again; every process stopped."""
    import signal

    t_leg = time.perf_counter()
    work = os.path.join(root, "deploy")
    os.makedirs(work, exist_ok=True)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (HERE, os.environ.get("PYTHONPATH")) if p)}
    procs: dict = {}
    fast = ["--heartbeat-interval", str(DEPLOY_HEARTBEAT_S)]
    # the roles run on the card unless this run is a CPU rehearsal
    dev = ["--device", DEVICE] if DEVICE else []

    def spawn(name, *args):
        log_f = open(os.path.join(work, f"{name}.log"), "wb")
        procs[name] = (subprocess.Popen(
            [sys.executable, "-m", "greptimedb_tpu_torch", *args],
            stdout=log_f, stderr=subprocess.STDOUT, env=env, cwd=HERE),
            log_f)

    def tail(name):
        with open(os.path.join(work, f"{name}.log"), "rb") as f:
            return f.read()[-2000:].decode(errors="replace")

    def wait_port(name, timeout_s=120.0):
        path = os.path.join(work, f"{name}.port")
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            proc = procs[name][0]
            check(proc.poll() is None,
                  f"deploy: {name} died at startup:\n{tail(name)}")
            if os.path.exists(path):
                return int(open(path).read().strip())
            time.sleep(0.05)
        check(False, f"deploy: {name} not up in {timeout_s} s")

    out: dict = {"hosts": DEPLOY_HOSTS,
                 "cut": f"the hour's first {DEPLOY_HOSTS} of {HOSTS} hosts"}
    try:
        used0 = gpu_used_mib() if not dev else 0
        t = time.perf_counter()
        spawn("metasrv", "metasrv", "start", "--data-home",
              os.path.join(work, "meta"), "--bind-addr", "127.0.0.1:0",
              "--port-file", os.path.join(work, "metasrv.port"), *fast)
        ms = f"127.0.0.1:{wait_port('metasrv')}"
        for i in range(3):
            spawn(f"dn-{i}", "datanode", "start", "--node-id", f"dn-{i}",
                  "--metasrv", ms, "--data-home",
                  os.path.join(work, "shared"), "--port-file",
                  os.path.join(work, f"dn-{i}.port"), *fast, *dev)
        spawn("frontend", "frontend", "start", "--metasrv", ms,
              "--http-addr", "127.0.0.1:0", "--port-file",
              os.path.join(work, "frontend.port"), *dev)
        spawn("flownode", "flownode", "start", "--metasrv", ms,
              "--tick-interval", str(DEPLOY_FLOW_TICK_S), "--port-file",
              os.path.join(work, "flownode.port"), *dev)
        ready = {}
        for name in ("dn-0", "dn-1", "dn-2", "frontend", "flownode"):
            wait_port(name)
            ready[name] = time.perf_counter() - t
        fe = wait_port("frontend")
        out["ready_s"] = ready
        if not dev:
            out["gpu"] = children_on_card(
                {n: procs[n][0].pid for n in ("dn-0", "dn-1", "dn-2")},
                used0, "deploy")
        log("cluster (l) deploy up: " + json.dumps(out))
        doc = http_sql(fe, cluster_ddl().replace("CREATE TABLE cpu ",
                                                 "CREATE TABLE cpu_lp "))
        check(doc.get("code") == 0, f"deploy: CREATE TABLE {doc}")
        doc = http_sql(fe, DEPLOY_FLOW_SQL)
        check(doc.get("code") == 0, f"deploy: CREATE FLOW {doc}")
        t = time.perf_counter()
        bodies = cpu_lp_bodies(grid, host_names, DEPLOY_HOSTS)
        build_s = time.perf_counter() - t
        sent = post_all(fe, "/v1/influxdb/write?precision=ms", bodies,
                        LP_CLIENTS, {"Content-Type": "text/plain"})
        check(sent["status"] == [204] * len(bodies),
              f"deploy: not every body got 204 ({sent['first_error']})")
        rows = 3600 // STEP_S * DEPLOY_HOSTS
        out["write"] = {"rows": rows, "bodies": len(bodies),
                        "build_s": build_s, "wall_s": sent["wall_s"],
                        "rows_per_s": rows / sent["wall_s"],
                        "ack_p99_ms": sent["p99_ms"]}
        doc = http_sql(fe, "SELECT count(*) FROM cpu_lp")
        check(doc.get("code") == 0 and doc["output"][0]["records"]["rows"]
              == [[rows]], f"deploy: count(*) {str(doc)[:200]}")
        # the flownode's ticks fold the hour into its sink: each host's
        # hourly avg(usage_user) against numpy, within 30 s
        order = np.argsort(np.asarray(
            [f"host_{i}" for i in range(DEPLOY_HOSTS)]), kind="stable")
        want = grid["usage_user"][:, :DEPLOY_HOSTS].mean(axis=0)[order]
        t = time.perf_counter()
        while True:
            doc = http_sql(fe, "SELECT hostname, a, c FROM lp_hourly "
                           "ORDER BY hostname")
            got = doc["output"][0]["records"]["rows"] \
                if doc.get("code") == 0 else []
            if len(got) == DEPLOY_HOSTS and all(r[2] == 3600 // STEP_S
                                                for r in got):
                break
            check(time.perf_counter() - t < 30.0,
                  f"deploy: the flow's sink holds {len(got)} complete "
                  f"hosts after 30 s ({str(doc)[:200]})")
            time.sleep(0.25)
        check(np.allclose(np.asarray([r[1] for r in got], dtype=np.float64),
                          want, rtol=1e-9, atol=0),
              "deploy: the flow's hourly avg against numpy")
        out["flow"] = {"sink_rows": len(got),
                       "seconds_after_write": time.perf_counter() - t}
        stmts = {name: queries[name][0].replace(" FROM cpu ",
                                                " FROM cpu_lp ")
                 for name in ("double_groupby_all (1 h)", "cpu_max_all_8")}
        out["queries"] = {}
        for name, sql in stmts.items():
            t = time.perf_counter()
            doc = http_sql(fe, sql)
            q_ms = (time.perf_counter() - t) * 1e3
            http_rows_match(doc, answers[name], f"deploy {name}",
                            DEPLOY_HOSTS)
            out["queries"][name] = {"ms": q_ms}
        # kill -9 the datanode of the largest region; the metasrv's own
        # ticker fails it over
        from greptimedb_tpu_torch.meta.kv_service import HttpKv
        from greptimedb_tpu_torch.meta.route import ROUTE_PREFIX

        routes = [json.loads(v) for _, v in HttpKv(ms).range(ROUTE_PREFIX)]
        rr = max((r for route in routes for r in route["regions"]),
                 key=lambda r: r["region_id"] & 0xFFFF)
        victim = rr["leader_node"]
        procs[victim][0].kill()
        procs[victim][0].wait()
        t = time.perf_counter()
        name = "double_groupby_all (1 h)"
        while True:
            doc = http_sql(fe, stmts[name])
            if doc.get("code") == 0:
                break
            check(time.perf_counter() - t < 60.0,
                  f"deploy: no failover of {victim} in 60 s: "
                  f"{str(doc)[:300]}")
            time.sleep(0.25)
        out["failover"] = {"victim": victim,
                           "seconds": time.perf_counter() - t}
        http_rows_match(doc, answers[name], "deploy after failover",
                        DEPLOY_HOSTS)
        doc = http_sql(fe, stmts["cpu_max_all_8"])
        http_rows_match(doc, answers["cpu_max_all_8"],
                        "deploy cpu_max_all_8 after failover", DEPLOY_HOSTS)
        log("cluster (l) deploy failover: " + json.dumps(out["failover"]))
    finally:
        t_stop = time.perf_counter()
        for proc, _log in procs.values():
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
        deadline = time.monotonic() + 20
        for proc, log_f in procs.values():
            try:
                proc.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            log_f.close()
    check(not any(alive(p.pid) for p, _ in procs.values()),
          "deploy: a role process outlived its stop")
    out["exit_codes"] = {n: p.returncode for n, (p, _) in procs.items()}
    out["stop_s"] = time.perf_counter() - t_stop
    out["seconds"] = time.perf_counter() - t_leg
    log(f"cluster (l) deploy leg: {out['seconds']:.1f} s: "
        + json.dumps({k: out.get(k) for k in ("cut", "write", "flow",
                                              "queries", "exit_codes",
                                              "stop_s")}))
    return out


def cluster_phase(sk, torch, lib=None) -> dict:
    """Phase (l): the in-process Cluster on the card, three datanodes,
    the hour of cpu_1h through the scatter write; every statement against
    numpy with its fragment's K2 launches; a failover; the process leg
    (three datanode processes on the card, the answers held to the
    in-process ones, the datanodes' K2 launches from their reports, a
    kill -9 failover); the deploy leg (the CLI roles as processes); a
    standalone partitioned table's MergeScan through K1 and K2."""
    import shutil
    import tempfile

    from greptimedb_tpu_torch.cluster import Cluster
    from greptimedb_tpu_torch.query.engine import _cached_rule

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_cluster_")
    host_names = np.asarray([f"host_{i}" for i in range(HOSTS)],
                            dtype=object)
    out: dict = {"cut": "phase (k)'s lockdep traffic runs LOCKDEP_SECONDS "
                 f"= {LOCKDEP_SECONDS} s (30 s before phase (l))"}
    queries = cluster_queries()
    c = Cluster(os.path.join(root, "inproc"), num_datanodes=3,
                device=DEVICE)
    try:
        # ---- the hour through the scatter write, in process ----
        t_leg = time.perf_counter()
        c.sql(cluster_ddl())
        info = c.catalog.table("public", "cpu")
        batch, grid = cluster_batch(info, host_names)
        t = time.perf_counter()
        n = c.frontend._sharded_write(info, batch, delete=False)
        put_s = time.perf_counter() - t
        rule = _cached_rule(info)
        want = np.bincount(rule.find_regions([host_names]),
                           minlength=3) * (3600 // STEP_S)
        got = [c.router.scan(rid, projection=["ts"]).num_rows
               for rid in info.region_ids]
        nodes = [leader_of(c, rid) for rid in info.region_ids]
        count = c.sql("SELECT count(*) FROM cpu").rows()[0][0]
        check(n == HOSTS * 360 and got == list(want) and count == n
              and len(set(nodes)) == 3,
              f"cluster scatter: {n} rows, regions {got} (rule {want}), "
              f"count(*) {count}, nodes {nodes}")
        c.sql("ADMIN flush_table('cpu')")
        out["scatter"] = {"rows": n, "seconds": put_s,
                          "rows_per_s": n / put_s, "region_rows": got,
                          "region_hosts": [int(x) for x in want // 360],
                          "nodes": nodes}
        log("cluster (l) scatter: " + json.dumps(out["scatter"]))
        meter = FragmentMeter(c)
        answers, reports = {}, {}
        frag_case = None
        for name in CLUSTER_QUERIES:
            sql, path = queries[name]
            if name == "double_groupby_all (1 h)":
                (rep, res), seen = capture_k2(sk, lambda: cluster_statement(
                    c, meter, sk, torch, name, sql, path, grid,
                    lambda x: x))
                frag_case = seen
            else:
                rep, res = cluster_statement(c, meter, sk, torch, name, sql,
                                             path, grid, lambda x: x)
            if path != "rows_pushdown":
                regions = sum(1 for r in got if r)
                check(1 <= rep["k2_launches"] <= regions,
                      f"cluster {name}: {rep['k2_launches']} K2 launches")
            else:
                check(rep["k2_launches"] == 0,
                      f"cluster {name}: rows fragments launched K2")
            answers[name], reports[name] = res, rep
            log(f"cluster (l) {name}: " + json.dumps(rep))
        check(reports["double_groupby_all (1 h)"]["k2_launches"] == 3,
              "double_groupby_all: one K2 launch a region")
        # the window pushdown and the vmapped batch, in process: the
        # process leg's answers are held to these
        zero_launches(sk)
        res, ms = timed_query(c.frontend, window_sql(), torch)
        check(c.frontend.executor.last_path == "window_pushdown",
              f"cluster window: {c.frontend.executor.last_path}")
        check_window(res, grid, "cluster window")
        answers["window (lag, 10 min)"] = res
        reports["window (lag, 10 min)"] = {
            "last_path": "window_pushdown", "rows": res.num_rows,
            "cold_ms": ms, "k1_launches": launches(sk)[0],
            "k2_launches": launches(sk)[1]}
        meter.reset()
        zero_launches(sk)
        dres, ms, path = dash_batch(c.frontend, torch)
        check(path == "vmapped_fragments", f"cluster dash batch: {path}")
        check_dash(dres, grid, "cluster dash batch")
        k1, k2 = launches(sk)
        check(k1 == 0 and k2 == meter.planes == 3,
              f"cluster dash batch: K1 {k1}, K2 {k2} for {meter.planes} "
              "plane fragments (one a region)")
        answers["dash batch (8 members)"] = dres
        reports["dash batch (8 members)"] = {
            "last_path": path, "members": len(dres), "cold_ms": ms,
            "k1_launches": k1, "k2_launches": k2}
        for name in ("window (lag, 10 min)", "dash batch (8 members)"):
            log(f"cluster (l) {name}: " + json.dumps(reports[name]))
        out["statements"] = reports
        out["launches"] = {
            "k1_launches": sum(r["k1_launches"] for r in reports.values()),
            "k2_launches": sum(r["k2_launches"] for r in reports.values())}
        # the fragment's K2 at the largest region's shape, against its
        # plain version
        if lib is not None and frag_case:
            out["fragment_case"] = k2_case(
                sk, lib, torch, frag_case["vals"], frag_case["ids"],
                frag_case["g"], frag_case["want"], "fragment",
                "double_groupby_all (1 h), the largest region")
        else:
            out["fragment_case"] = {"shape": list(frag_case["vals"].shape)
                                    if frag_case else None}
        # ---- failover: region 2's datanode dies ----
        sql_f = queries["double_groupby_all (10 min)"][0]
        tick_ms = 0.0
        for _ in range(5):
            c.beat_all(tick_ms)
            tick_ms += 3000.0
        extra, _g = cluster_batch(info, host_names)
        extra = extra.take(np.arange(HOSTS))  # one more point, WAL only
        extra.columns["ts"] = extra.columns["ts"] + 3600 * 1000
        c.frontend._sharded_write(info, extra, delete=False)
        before = c.sql(sql_f)
        rid2 = info.region_ids[2]
        victim = leader_of(c, rid2)
        c.datanodes[victim].kill()
        ticks = 0
        zero_launches(sk)
        t = time.perf_counter()
        while True:
            for dn in c.datanodes.values():
                dn.beat(tick_ms)
            ticks += 1
            if c.tick(tick_ms):
                break
            check(ticks < 200, "cluster failover: no failover started")
            tick_ms += 3000.0
        c.beat_all(tick_ms)
        new = leader_of(c, rid2)
        replayed = c.datanodes[new].engine.region(rid2).replayed_entries
        after = c.sql(sql_f)
        fo_s = time.perf_counter() - t
        k1, k2 = launches(sk)
        same_rows(after, before, "cluster failover: double_groupby_all")
        check(new != victim and replayed > 0,
              f"cluster failover: {victim} -> {new}, {replayed} replayed")
        out["failover"] = {"victim": victim, "new_leader": new,
                           "ticks": ticks, "wal_entries_replayed": replayed,
                           "seconds": fo_s, "k1_launches": k1,
                           "k2_launches": k2}
        log("cluster (l) failover: " + json.dumps(out["failover"]))
        c.close()
        c = None
        out["in_process_seconds"] = time.perf_counter() - t_leg
        # ---- the process leg: three datanode processes on the card ----
        out["process"] = process_leg(sk, torch, lib, root, host_names,
                                     queries, answers)
        # ---- the deploy leg: the CLI roles ----
        out["deploy"] = deploy_leg(root, host_names, grid, queries,
                                   out["process"].pop("answers"))
        # ---- a standalone partitioned table: MergeScan through K1, K2 ----
        t_leg = time.perf_counter()
        engine, qe = open_engine(os.path.join(root, "standalone"))
        try:
            qe.execute_one(cluster_ddl())
            sinfo = qe.catalog.table("public", "cpu")
            sbatch, _g = cluster_batch(sinfo, host_names)
            qe._sharded_write(sinfo, sbatch, delete=False)
            qe.execute_one("ADMIN flush_table('cpu')")
            from greptimedb_tpu_torch import config as port_config

            f32 = f32_exact if port_config.compute_dtype(qe.device) \
                == torch.float32 else (lambda x: x)
            stand = {}
            for name, want_k in (("double_groupby_all (10 min)", 0),
                                 ("cpu_max_all_8", 1)):
                zero_launches(sk)
                res, ms = timed_query(qe, queries[name][0], torch)
                k = launches(sk)
                check_cluster(name, res, grid, f32)
                check(k[want_k] > 0, f"standalone {name}: launches {k} "
                      f"on {qe.executor.last_path}")
                stand[name] = {"last_path": qe.executor.last_path,
                               "ms": ms, "k1_launches": k[0],
                               "k2_launches": k[1]}
            out["standalone"] = stand
            log("cluster (l) standalone MergeScan: " + json.dumps(stand))
        finally:
            engine.close()
        out["standalone_seconds"] = time.perf_counter() - t_leg
    finally:
        if c is not None:
            c.close()
        shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"cluster (l): {out['seconds']:.1f} s (in process "
        f"{out['in_process_seconds']:.1f}, processes "
        f"{out['process']['seconds']:.1f}, deploy "
        f"{out['deploy']['seconds']:.1f}, standalone "
        f"{out['standalone_seconds']:.1f}); {out['cut']}")
    return out


# ---- RANGE ... ALIGN on the `cpu` table --------------------------------------

#: the full-width RANGE query's step and its slots: 1 h windows at 5 min
ALIGN_S = 300
RANGE_SLOTS = 3600 // ALIGN_S
#: the FILL query: these first hosts over the first hour, 5 s windows
FILL_HOSTS = 8


def range_sql() -> str:
    """A 12 h panel of 1 h moving averages and maxima, and 10 min minima,
    at 5 min resolution for every host."""
    return ("SELECT ts, hostname, avg(usage_user) RANGE '1h', "
            "max(usage_user) RANGE '1h', min(usage_system) RANGE '10m' "
            "FROM cpu ALIGN '5m' BY (hostname)")


def fill_sql() -> str:
    hosts = ", ".join(f"'host_{i}'" for i in range(FILL_HOSTS))
    return ("SELECT ts, hostname, last_value(usage_user) RANGE '5s' "
            "FILL PREV, avg(usage_system) RANGE '5s' FILL LINEAR FROM cpu "
            f"WHERE hostname IN ({hosts}) AND ts >= {T0_MS} "
            f"AND ts < {T0_MS + 3600 * 1000} ALIGN '5s' BY (hostname)")


def check_range_result(res, grid, what) -> int:
    """The RANGE query against float64 numpy over `grid` ([points, hosts]
    per field): one row per host and window from the 11 leading partial
    windows to the last point's, series-major in hostname order; avg to
    rtol 1e-9, max and min exactly, NULL where a 10 min window saw no
    row. Returns the windows a host."""
    pts = grid["usage_user"].shape[0]
    per = ALIGN_S // STEP_S
    lead = RANGE_SLOTS - 1
    n_win = lead + -(-pts // per)
    check(res.num_rows == HOSTS * n_win,
          f"{what}: {res.num_rows} rows, expected {HOSTS * n_win}")
    ts, names, avg, mx, mn = (np.asarray(c) for c in res.columns)
    order = check_host_blocks(names, n_win, what)
    check(np.array_equal(ts.astype(np.int64), np.tile(
        T0_MS + (np.arange(n_win) - lead) * ALIGN_S * 1000, HOSTS)),
        f"{what}: window timestamps")
    want = np.full((3, n_win, HOSTS), np.nan)
    for k in range(n_win):
        a = max((k - lead) * per, 0)
        hour = grid["usage_user"][a:(k - lead + RANGE_SLOTS) * per]
        want[0, k] = hour.mean(axis=0)
        want[1, k] = hour.max(axis=0)
        ten = grid["usage_system"][a:max((k - lead + 2) * per, 0)]
        if len(ten):
            want[2, k] = ten.min(axis=0)
    want = want[:, :, order].transpose(0, 2, 1).reshape(3, -1)
    got_avg = avg.astype(np.float64)
    check(np.allclose(got_avg, want[0], rtol=1e-9, atol=0),
          f"{what} avg: max rel err "
          f"{np.max(np.abs(got_avg - want[0]) / np.abs(want[0]))}")
    check(np.array_equal(mx.astype(np.float64), want[1]), f"{what} max")
    check(np.array_equal(mn.astype(np.float64), want[2], equal_nan=True),
          f"{what} min (NULL where the 10 min window is empty)")
    check(int(np.isnan(mn.astype(np.float64)).sum()) == HOSTS * (lead - 1),
          f"{what}: NULL min count")
    return n_win


def range_phase(qe, sk, torch, grid, state, timed) -> dict:
    """The full-width RANGE query through execute_one: two distinct
    ranges, so two K2 calls over [S·N] = [12 x 17.28 M] slot-replicated
    float64 rows into 4,096 x 256 + 1 segments, and no K1; the counts
    zeroed just before and read just after. `timed` adds five warm runs,
    a CUPTI profile and a cProfile breakdown."""
    sql = range_sql()
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()
    zero_launches(sk)
    res, cold = timed_query(qe, sql, torch)
    k1, k2 = launches(sk)
    n_win = check_range_result(res, grid, f"{state} range")
    check(k1 == 0 and k2 == 2, f"{state} range: K1 {k1}, K2 {k2} launches, "
          "expected K2 twice (one a distinct range) and no K1")
    out = {"rows": res.num_rows, "windows_a_host": n_win, "cold_ms": cold,
           "k1_launches": k1, "k2_launches": k2,
           "max_memory_allocated": torch.cuda.max_memory_allocated()
           if torch.cuda.is_available() else None}
    if timed:
        warm = [timed_query(qe, sql, torch)[1] for _ in range(5)]
        out["warm_p50_ms"] = float(np.median(warm))
        if torch.cuda.is_available():
            out["profile"] = device_breakdown(lambda: qe.execute_one(sql),
                                              torch)
        out["host"] = host_breakdown(lambda: qe.execute_one(sql))
    log(f"{state} range query: " + json.dumps(out))
    return out


def range_fill_phase(qe, sk, torch, grid) -> dict:
    """RANGE with FILL on the card: FILL_HOSTS hosts over the first hour
    at 5 s windows. Every other window is empty (10 s samples):
    last_value FILL PREV repeats the window before, avg FILL LINEAR takes
    the midpoint of its neighbours; one K2 call (one distinct range),
    `last` through segment_agg's torch code."""
    sql = fill_sql()
    zero_launches(sk)
    res, ms = timed_query(qe, sql, torch)
    k1, k2 = launches(sk)
    per_host = 2 * 360 - 1  # 5 s windows from the first to the last point
    check(res.num_rows == FILL_HOSTS * per_host,
          f"range fill: {res.num_rows} rows")
    check(k1 == 0 and k2 == 1, f"range fill: K1 {k1}, K2 {k2} launches")
    ts, names, last, avg = (np.asarray(c) for c in res.columns)
    check(list(names) == [f"host_{h}" for h in range(FILL_HOSTS)
                          for _ in range(per_host)], "range fill: hostnames")
    check(np.array_equal(ts.astype(np.int64), np.tile(
        T0_MS + np.arange(per_host) * 5000, FILL_HOSTS)),
        "range fill: window timestamps")
    even = np.arange(0, per_host, 2)
    odd = np.arange(1, per_host, 2)
    for h in range(FILL_HOSTS):
        user = grid["usage_user"][:360, h]
        system = grid["usage_system"][:360, h]
        want_last = np.repeat(user, 2)[:per_host]
        want_avg = np.empty(per_host)
        want_avg[even] = system
        want_avg[odd] = np.interp(odd, even, system)
        rows = slice(h * per_host, (h + 1) * per_host)
        check(np.array_equal(last[rows].astype(np.float64), want_last),
              f"range fill: last_value FILL PREV of host_{h}")
        check(np.allclose(avg[rows].astype(np.float64), want_avg,
                          rtol=1e-12, atol=0),
              f"range fill: avg FILL LINEAR of host_{h}")
    out = {"rows": res.num_rows, "ms": ms, "k1_launches": k1,
           "k2_launches": k2}
    log("range fill query: " + json.dumps(out))
    return out


# ---- the host SQL surface on the `cpu` table --------------------------------

#: Q1's top-N hosts by their peak usage_user
TOP_N = 10
#: the routes a host SQL query's inner aggregates may take: K1 or K2
DEVICE_ROUTES = ("dense_prepared", "dense_fused")
HOURLY_SQL = ("SELECT hostname, date_bin(INTERVAL '1 hour', ts) AS h, "
              "avg(usage_user) AS a FROM cpu GROUP BY hostname, h")


def host_sql_queries(top_hosts) -> dict:
    """The seven dashboard statements: name -> (setup SQL run once before
    it, the SQL timed (one execute_sql call), the statements whose device
    aggregates run inside it, each as it runs alone). `top_hosts` are
    the oracle's top-N names, for Q1's literal IN-list twin."""
    last_hour = T0_MS + (HOURS - 1) * 3600 * 1000
    top_sql = ("SELECT hostname, max(usage_user) AS m FROM cpu GROUP BY "
               f"hostname ORDER BY m DESC, hostname LIMIT {TOP_N}")
    drill = ("SELECT date_bin(INTERVAL '1 hour', ts) AS h, hostname, "
             "avg(usage_user) AS a FROM cpu WHERE hostname IN ({}) "
             "GROUP BY h, hostname ORDER BY h, hostname")
    by_host = ("SELECT hostname, {}({}) AS {} FROM cpu GROUP BY hostname")
    return {
        "top_hosts_drilldown": (
            None, f"WITH top AS ({top_sql}) "
            + drill.format("SELECT hostname FROM top"),
            [top_sql, drill.format(", ".join(f"'{h}'" for h in top_hosts))]),
        "hourly_delta": (
            None, "SELECT hostname, date_bin(INTERVAL '1 hour', ts) AS h, "
            "avg(usage_user) AS a, lag(avg(usage_user)) OVER (PARTITION BY "
            "hostname ORDER BY date_bin(INTERVAL '1 hour', ts)) AS prev "
            "FROM cpu GROUP BY hostname, h ORDER BY hostname, h",
            [HOURLY_SQL]),
        "hourly_rank": (
            None, "SELECT h, hostname, a, rank() OVER (PARTITION BY h ORDER "
            f"BY a DESC) AS r FROM ({HOURLY_SQL}) t ORDER BY h, r, hostname",
            [HOURLY_SQL]),
        "moving_avg": (
            None, "SELECT hostname, ts, avg(usage_user) OVER (PARTITION BY "
            "hostname ORDER BY ts ROWS BETWEEN 5 PRECEDING AND CURRENT ROW) "
            f"AS ma FROM cpu WHERE ts >= {last_hour} ORDER BY hostname, ts",
            []),
        "user_vs_system": (
            None, f"WITH u AS ({by_host.format('avg', 'usage_user', 'a')}), "
            f"s AS ({by_host.format('max', 'usage_system', 'm')}) "
            "SELECT u.hostname, u.a, s.m FROM u JOIN s ON "
            "u.hostname = s.hostname ORDER BY u.hostname",
            [by_host.format("avg", "usage_user", "a"),
             by_host.format("max", "usage_system", "m")]),
        # cpu_1h keys on (hostname, h) without append mode: a repeated
        # INSERT overwrites its rows (last write wins)
        "rollup_insert": (
            "CREATE TABLE cpu_1h (hostname STRING, h TIMESTAMP(3) NOT NULL, "
            "a DOUBLE, TIME INDEX (h), PRIMARY KEY (hostname))",
            f"INSERT INTO cpu_1h {HOURLY_SQL}; "
            "SELECT count(*), avg(a) FROM cpu_1h",
            [HOURLY_SQL, "SELECT count(*), avg(a) FROM cpu_1h"]),
        "view_hourly": (
            f"CREATE VIEW hourly AS {HOURLY_SQL}",
            "SELECT hostname, max(a) FROM hourly GROUP BY hostname "
            "ORDER BY hostname", [HOURLY_SQL]),
    }


def check_host_sql(name, results, grid, top_hosts) -> None:
    """Every value of one host SQL query against float64 numpy over
    `grid`: max and min exactly (as the f32 kernels see them), averages
    to rtol 1e-5, counts exactly, lag equal to the previous row's
    returned avg, ranks recomputed from the returned avgs."""
    res = results[-1]
    per_hour = 3600 // STEP_S
    user = grid["usage_user"][:HOURS * per_hour]
    hourly = user.reshape(HOURS, per_hour, HOSTS).mean(axis=1)
    lex = np.argsort(np.asarray([f"host_{i}" for i in range(HOSTS)]),
                     kind="stable")
    cols = [np.asarray(c) for c in res.columns]

    def close(got, want, rtol, what):
        got = np.asarray(got, dtype=np.float64)
        check(got.shape == want.shape and np.allclose(got, want, rtol=rtol,
                                                      atol=0),
              f"host sql {name} {what}: max rel err "
              f"{np.max(np.abs(got - want) / np.abs(want))}")

    if name == "top_hosts_drilldown":
        hosts = np.sort(np.asarray(top_hosts))
        idx = host_index(hosts)
        check(res.num_rows == HOURS * TOP_N, f"{name}: {res.num_rows} rows")
        hours = np.repeat(np.arange(HOURS), TOP_N)
        check(np.array_equal(cols[0].astype(np.int64),
                             T0_MS + hours * 3_600_000), f"{name} hours")
        check(list(cols[1].astype(str)) == list(hosts) * HOURS,
              f"{name} hostnames")
        close(cols[2], hourly[hours, np.tile(idx, HOURS)], 1e-5, "avg")
    elif name in ("hourly_delta", "hourly_rank"):
        check(res.num_rows == HOSTS * HOURS, f"{name}: {res.num_rows} rows")
        if name == "hourly_delta":
            host, hour, a, prev = cols
            want_host = np.repeat(lex, HOURS)
            want_hour = np.tile(np.arange(HOURS), HOSTS)
        else:
            hour, host, a, r = cols
            want_hour = np.repeat(np.arange(HOURS), HOSTS)
            want_host = None
        check(np.array_equal(hour.astype(np.int64),
                             T0_MS + want_hour * 3_600_000), f"{name} hours")
        hidx = host_index(host)
        if want_host is not None:
            check(np.array_equal(hidx, want_host), f"{name} hostnames")
        else:
            check(np.array_equal(np.sort(hidx.reshape(HOURS, HOSTS), axis=1),
                                 np.tile(np.arange(HOSTS), (HOURS, 1))),
                  f"{name}: every host in every hour")
        a = a.astype(np.float64)
        close(a, hourly[want_hour, hidx], 1e-5, "avg")
        if name == "hourly_delta":
            first = want_hour == 0
            check(all(v is None for v in prev[first]),
                  f"{name}: lag is NULL on each host's first hour")
            check(np.array_equal(prev[~first].astype(np.float64),
                                 a[np.flatnonzero(~first) - 1]),
                  f"{name}: lag equals the previous row's avg")
        else:
            blocks = a.reshape(HOURS, HOSTS)
            check(bool(np.all(np.diff(blocks, axis=1) <= 0)),
                  f"{name}: avg not descending within an hour")
            pos = np.tile(np.arange(1, HOSTS + 1), (HOURS, 1))
            new = np.concatenate([np.ones((HOURS, 1), bool),
                                  np.diff(blocks, axis=1) != 0], axis=1)
            want_r = np.maximum.accumulate(np.where(new, pos, 0), axis=1)
            check(np.array_equal(r.astype(np.int64).reshape(HOURS, HOSTS),
                                 want_r), f"{name}: ranks")
    elif name == "moving_avg":
        x = user[-per_hour:]  # [points of the last hour, hosts]
        check(res.num_rows == per_hour * HOSTS, f"{name}: {res.num_rows} rows")
        check(np.array_equal(host_index(cols[0]), np.repeat(lex, per_hour)),
              f"{name} hostnames")
        check(np.array_equal(cols[1].astype(np.int64), np.tile(
            T0_MS + (HOURS * per_hour - per_hour + np.arange(per_hour))
            * STEP_S * 1000, HOSTS)), f"{name} timestamps")
        cs = np.concatenate([np.zeros((1, HOSTS)), np.cumsum(x, axis=0)])
        p = np.arange(per_hour)
        lo = np.maximum(p - 5, 0)
        want = (cs[p + 1] - cs[lo]) / (p + 1 - lo)[:, None]
        # the window sums as cumulative-sum differences over the whole
        # relation: about 1e-8 relative error at 1.44 M rows
        close(cols[2], want[:, lex].T.reshape(-1), 1e-5, "moving avg")
    elif name == "user_vs_system":
        check(res.num_rows == HOSTS, f"{name}: {res.num_rows} rows")
        check(np.array_equal(host_index(cols[0]), lex), f"{name} hostnames")
        close(cols[1], user.mean(axis=0)[lex], 1e-5, "avg")
        system = grid["usage_system"][:HOURS * per_hour]
        check(np.array_equal(cols[2].astype(np.float64),
                             f32_exact(system.max(axis=0))[lex]),
              f"{name} max")
    elif name == "rollup_insert":
        check(results[0].affected_rows == HOSTS * HOURS,
              f"{name}: {results[0].affected_rows} rows written")
        check(int(cols[0][0]) == HOSTS * HOURS, f"{name}: count {cols[0][0]}")
        close(cols[1], np.asarray([hourly.mean()]), 1e-5, "avg")
    else:  # view_hourly
        check(res.num_rows == HOSTS, f"{name}: {res.num_rows} rows")
        check(np.array_equal(host_index(cols[0]), lex), f"{name} hostnames")
        close(cols[1], hourly.max(axis=0)[lex], 1e-5, "max of avg")


def host_sql_phase(qe, sk, torch, grid) -> dict:
    """The seven host SQL statements at full width on the `cpu` table,
    partial cache off: each cold (its first run in this process; the
    hot set already holds the table's blocks), five times warm, once
    under torch.profiler, every value against numpy. Each one's inner
    aggregates must take K1 or K2 (DEVICE_ROUTES), each the route the
    same statement takes alone, with that kernel launched; Q4's raw scan
    takes none. The counts are zeroed just before each cold run and read
    just after it. cpu_1h and the view are dropped at the end."""
    t_phase = time.perf_counter()
    user = grid["usage_user"][:HOURS * 3600 // STEP_S]
    peak = f32_exact(user.max(axis=0))
    top = sorted(range(HOSTS), key=lambda i: (-peak[i], f"host_{i}"))[:TOP_N]
    top_hosts = [f"host_{i}" for i in top]
    out: dict = {}
    total = {"segment_sum": 0, "fused_segment_agg": 0}
    with partial_cache(False):
        for name, (setup, sql, alone) in host_sql_queries(top_hosts).items():
            if setup is not None:
                qe.execute_one(setup)
            if torch.cuda.is_available():
                torch.cuda.reset_peak_memory_stats()
            zero_launches(sk)
            sync(torch)
            t = time.perf_counter()
            results = qe.execute_sql(sql)
            sync(torch)
            cold = (time.perf_counter() - t) * 1e3
            k1, k2 = launches(sk)
            paths = list(qe.executor.statement_paths)
            check_host_sql(name, results, grid, top_hosts)
            q = {"cold_ms": cold, "rows": results[-1].num_rows,
                 "paths": paths, "k1_launches": k1, "k2_launches": k2,
                 "peak_device_bytes": torch.cuda.max_memory_allocated()
                 if torch.cuda.is_available() else None}
            total["segment_sum"] += k1
            total["fused_segment_agg"] += k2
            warm = []
            for _ in range(5):
                sync(torch)
                t = time.perf_counter()
                qe.execute_sql(sql)
                sync(torch)
                warm.append((time.perf_counter() - t) * 1e3)
            q["warm_p50_ms"] = float(np.median(warm))
            if torch.cuda.is_available():
                prof = device_breakdown(lambda: qe.execute_sql(sql), torch)
                q["device_ms"] = prof["device_ms"]
                q["idle_share"] = prof["idle_share"]
                q["device_top"] = prof["top"]
            if name == "moving_avg":
                q["host"] = host_breakdown(lambda: qe.execute_sql(sql))
            # each inner statement alone: its route is the one it took
            # inside the query, and that route is a kernel's
            q["alone_paths"] = []
            for stmt in alone:
                qe.execute_one(stmt)
                q["alone_paths"].append(qe.executor.last_path)
            check(paths == q["alone_paths"],
                  f"host sql {name}: routes {paths}, alone "
                  f"{q['alone_paths']}")
            check(all(p in DEVICE_ROUTES for p in paths),
                  f"host sql {name}: an inner aggregate left the K1/K2 "
                  f"routes: {paths}")
            check(("dense_prepared" not in paths or k1 > 0)
                  and ("dense_fused" not in paths or k2 > 0)
                  and (k1 + k2 > 0) == bool(paths),
                  f"host sql {name}: K1 {k1}, K2 {k2} launches for routes "
                  f"{paths}")
            out[name] = q
            log(f"host sql {name}: " + json.dumps(q))
        qe.execute_one("DROP VIEW hourly")
        qe.execute_one("DROP TABLE cpu_1h")
    check(total["segment_sum"] > 0 or total["fused_segment_agg"] > 0,
          "host sql: no kernel was launched")
    log("host sql launches (cold runs): " + json.dumps(total)
        + f", phase {time.perf_counter() - t_phase:.1f} s")
    return {"launches": total, "queries": out}


# ---- the slice-3 routes: sparse, incremental, host aggregates --------------


class env_value:
    """An environment variable set in this process for a block, restored
    after it."""

    def __init__(self, name: str, value: str):
        self.name, self.value = name, value

    def __enter__(self):
        self.saved = os.environ.get(self.name)
        os.environ[self.name] = self.value

    def __exit__(self, *exc):
        if self.saved is None:
            os.environ.pop(self.name, None)
        else:
            os.environ[self.name] = self.saved
        return False


class partial_cache(env_value):
    """GREPTIMEDB_TPU_PARTIAL_CACHE set in this process for a block: the
    JAX package's own switch of the incremental fold (default on)."""

    def __init__(self, on: bool):
        super().__init__("GREPTIMEDB_TPU_PARTIAL_CACHE", "1" if on else "0")


def sparse_sql() -> str:
    return ("SELECT hostname, date_bin(INTERVAL '1 minute', ts) AS minute, "
            "avg(usage_user), max(usage_system), count(*) FROM cpu "
            "GROUP BY hostname, minute ORDER BY hostname, minute")


def host_order() -> np.ndarray:
    """Host indices in the order ORDER BY hostname gives them."""
    return np.argsort(np.asarray([f"host_{i}" for i in range(HOSTS)]),
                      kind="stable")


def check_host_blocks(col, per: int, what: str) -> np.ndarray:
    """`col` holds HOSTS runs of `per` equal hostnames in ORDER BY order:
    returns the run heads' host indices after checking every row."""
    names = np.asarray(col, dtype=object).reshape(HOSTS, per)
    check(bool((names == names[:, :1]).all()), f"{what}: hostname runs")
    heads = host_index(names[:, 0])
    check(np.array_equal(heads, host_order()), f"{what}: hostname order")
    return heads


def check_sparse_result(res, grid, what) -> None:
    """The sparse query against the float64 oracle over every point in
    `grid`, on arrays: keys, avg (f32 compute, rtol 1e-5), max (the f32
    cast of the f64 max, exact) and count (exact)."""
    pts = next(iter(grid.values())).shape[0]
    minutes = -(-pts // 6)
    cols = {n: np.asarray(c) for n, c in zip(res.names, res.columns)}
    check(res.num_rows == HOSTS * minutes,
          f"{what}: {res.num_rows} rows, expected {HOSTS * minutes}")
    order = check_host_blocks(cols["hostname"], minutes, what)
    check(np.array_equal(cols["minute"].astype(np.int64),
                         np.tile(T0_MS + np.arange(minutes) * 60_000,
                                 HOSTS)), f"{what}: minute keys")

    def per_minute(f, how):
        x = grid[f]
        pad = minutes * 6 - pts
        if pad:  # the last minute holds fewer points
            x = np.concatenate([x, np.full((pad, HOSTS), np.nan)])
        return how(x.reshape(minutes, 6, HOSTS), axis=1)[:, order].T \
            .reshape(-1)

    want_avg = per_minute("usage_user", np.nanmean)
    got = cols["avg(usage_user)"].astype(np.float64)
    check(np.allclose(got, want_avg, rtol=1e-5, atol=0),
          f"{what}: avg max rel err "
          f"{np.max(np.abs(got - want_avg) / np.abs(want_avg))}")
    check(np.array_equal(cols["max(usage_system)"].astype(np.float64),
                         f32_exact(per_minute("usage_system", np.nanmax))),
          f"{what}: max")
    want_n = per_minute("usage_user", lambda a, axis: (~np.isnan(a)).sum(
        axis=axis))
    check(np.array_equal(cols["count(*)"].astype(np.int64), want_n),
          f"{what}: count")


def launches(sk) -> tuple:
    return sk.segment_sum.launches, sk.fused_segment_agg.launches


def zero_launches(sk) -> None:
    sk.segment_sum.launches = 0
    sk.fused_segment_agg.launches = 0


def timed_query(qe, sql, torch):
    sync(torch)
    t = time.perf_counter()
    res = qe.execute_one(sql)
    sync(torch)
    return res, (time.perf_counter() - t) * 1e3


def sparse_phase(qe, sk, torch, grid, region) -> dict:
    """Check 1 (cache off): the hostname x minute query over the whole
    scan takes `sparse_fused`, one K2 call over U + 1 segments, no K1.
    Check 2 (cache on): the same query folds per-part sparse partials
    (`incremental_sparse`): every part misses cold and hits warm, and the
    warm repeat launches K2 only for the memtable tail."""
    from greptimedb_tpu_torch.ops.blocks import DEFAULT_BLOCK_ROWS

    sql = sparse_sql()
    out = {}
    with partial_cache(False):
        zero_launches(sk)
        res, cold = timed_query(qe, sql, torch)
        k1, k2 = launches(sk)
        path = qe.executor.last_path
        st = qe.executor.last_sparse_stats
        check(path == "sparse_fused", f"sparse: last_path {path}")
        check(k2 == 1 and k1 == 0, f"sparse: K1 {k1}, K2 {k2} launches, "
              "expected K2 once and no K1")
        check_sparse_result(res, grid, "sparse")
        check(st["groups"] == res.num_rows, f"sparse: observed {st}")
        warm = [timed_query(qe, sql, torch)[1] for _ in range(3)]
        prof = device_breakdown(lambda: qe.execute_one(sql), torch) \
            if torch.cuda.is_available() else None
        out["sparse"] = {"last_path": path, "k1_launches": k1,
                         "k2_launches": k2, "cold_ms": cold,
                         "warm_p50_ms": float(np.median(warm)), **st,
                         "profile": prof,
                         "host": host_breakdown(lambda: qe.execute_one(sql))}
        log("sparse query: " + json.dumps(out["sparse"]))
        want = res
    with partial_cache(True):
        runs = []
        for label in ("cold", "warm"):
            zero_launches(sk)
            res, ms = timed_query(qe, sql, torch)
            k1, k2 = launches(sk)
            st = dict(qe.executor.last_partial_stats or {})
            runs.append({"run": label, "last_path": qe.executor.last_path,
                         "ms": ms, "k1_launches": k1, "k2_launches": k2,
                         **st})
            check(runs[-1]["last_path"] == "incremental_sparse",
                  f"incremental sparse {label}: {runs[-1]['last_path']}")
            check_sparse_result(res, grid, f"incremental sparse {label}")
            if label == "cold":
                cold_res = res
        cold, warm = runs
        mem_rows = region.memtable.num_rows
        mem_blocks = -(-mem_rows // DEFAULT_BLOCK_ROWS)
        check(cold["parts"] == len(region.files) and cold["part_hits"] == 0
              and cold["part_misses"] == cold["parts"],
              f"incremental sparse cold: {cold}")
        check(warm["part_hits"] == warm["parts"] and warm["part_misses"] == 0
              and warm["delta_rows"] == warm["memtable_rows"] == mem_rows,
              f"incremental sparse warm: {warm}")
        check(warm["k2_launches"] == mem_blocks and warm["k1_launches"] == 0
              and cold["k2_launches"] == cold["parts"] + mem_blocks,
              f"incremental sparse launches: cold {cold}, warm {warm}")
        # the warm serve reuses the cached partials: equal to the cold one
        for a, b in zip(cold_res.columns, res.columns):
            check(np.array_equal(np.asarray(a), np.asarray(b)),
                  "incremental sparse: warm differs from cold")
        # the fold and the whole-scan route give the same groups
        for name in ("hostname", "minute", "count(*)", "max(usage_system)"):
            i = res.names.index(name)
            check(np.array_equal(np.asarray(res.columns[i]),
                                 np.asarray(want.columns[i])),
                  f"incremental sparse {name} differs from sparse_fused")
        warm_ms = [timed_query(qe, sql, torch)[1] for _ in range(2)]
        warm["warm_p50_ms"] = float(np.median([warm["ms"]] + warm_ms))
        warm["host"] = host_breakdown(lambda: qe.execute_one(sql))
        out["incremental_sparse"] = runs
        log("incremental sparse: " + json.dumps(runs))
    return out


def cached_expectations(state, full_multi_block) -> dict:
    """Route of each of the six queries with the partial cache on.
    Compacted: one file; a query whose scan keeps the whole file spans
    several device blocks past 8M rows, and the fold takes the classic
    route ("multi-block part"), as in the JAX package."""
    want = {name: ("bucket_topk+incremental" if name ==
                   "groupby_orderby_limit" else
                   None if name == "high_cpu_all" else "incremental")
            for name in tsbs_queries()}
    if state == "compacted" and full_multi_block:
        want["double_groupby_all"] = tsbs_queries()["double_groupby_all"][1]
    # the boundary gather reduces the lastpoint scan before the fold is
    # tried, in every state (the JAX package's order)
    want["lastpoint"] = tsbs_queries()["lastpoint"][1]
    return want


def run_cached_queries(qe, sk, torch, grid, state, off, region,
                       full_multi_block) -> dict:
    """The six queries with the partial cache on: a cold run and three
    warm repeats each, rows against the oracle, route and part stats
    checked. `state`: "ingest" (a cold fill; warm folds only the tail),
    "write" (after a small write: still all hits), "reopened" (the
    region's entries died with its close: misses again), "compacted".
    `off` has the same state's cache-off results (their warm p50 sits
    beside this one's)."""
    from greptimedb_tpu_torch.ops.blocks import DEFAULT_BLOCK_ROWS
    from greptimedb_tpu_torch.query import partial_cache as pc

    want = cached_expectations(state, full_multi_block)
    cache = pc.global_cache()
    out = {}
    with partial_cache(True):
        zero_launches(sk)
        for name, (sql, _, want_rows) in tsbs_queries().items():
            k0 = launches(sk)
            fb0 = cache.events["fallback"]
            res, cold = timed_query(qe, sql, torch)
            k1 = launches(sk)
            path = qe.executor.last_path
            st = qe.executor.last_partial_stats
            check(path == want[name], f"cache on, {state} {name}: last_path "
                  f"{path}, expected {want[name]}")
            check(want_rows is None or res.num_rows == want_rows,
                  f"cache on, {state} {name}: {res.num_rows} rows")
            check_result(name, res, grid)
            warm, wst = [], None
            for _ in range(3):
                w0 = launches(sk)
                wres, ms = timed_query(qe, sql, torch)
                warm.append(ms)
                w1 = launches(sk)
                wst = qe.executor.last_partial_stats
            check_result(name, wres, grid)
            if state == "ingest" and name == "double_groupby_all":
                log("cache on, host breakdown of a warm double_groupby_all: "
                    + json.dumps(host_breakdown(lambda: qe.execute_one(sql))))
            rec = {"last_path": path, "cold_ms": cold,
                   "warm_p50_ms": float(np.median(warm)),
                   "cache_off_warm_p50_ms": off.get(name, {}).get(
                       "warm_p50_ms"),
                   "cold_launches": [k1[0] - k0[0], k1[1] - k0[1]],
                   "warm_launches": [w1[0] - w0[0], w1[1] - w0[1]],
                   "cold_stats": st, "warm_stats": wst}
            out[name] = rec
            log(f"cache on, {state} query {name}: " + json.dumps(rec))
            if path is None:
                continue
            if "boundary+" in path:
                # a reduced scan never asks the cache
                check(st is None and cache.events["fallback"] == fb0,
                      f"cache on, {state} {name}: the fold was tried")
                continue
            if "incremental" not in path:
                check(st is None and cache.events["fallback"] > fb0,
                      f"cache on, {state} {name}: no typed fallback")
                continue
            mem_blocks = -(-wst["memtable_rows"] // DEFAULT_BLOCK_ROWS)
            check(wst["part_misses"] == 0
                  and wst["delta_rows"] == wst["memtable_rows"]
                  and sum(rec["warm_launches"]) == mem_blocks,
                  f"cache on, {state} {name}: the warm repeat folded more "
                  f"than the memtable tail: {rec}")
            if state == "write":
                check(st["part_misses"] == 0,
                      f"cache on, write {name}: a write missed parts: {st}")
            elif name != "groupby_orderby_limit":
                # bucket top-k's narrowed first scan is new to every state
                check(st["part_hits"] == 0 and st["part_misses"] > 0,
                      f"cache on, {state} {name}: cold run hit: {st}")
    total = launches(sk)
    log(f"cache on, {state} launches: " + json.dumps(
        {"segment_sum": total[0], "fused_segment_agg": total[1]}))
    if state in ("ingest", "reopened"):
        check(total[0] > 0 and total[1] > 0,
              f"cache on, {state}: a kernel was not launched: {total}")
    return {"launches": {"segment_sum": total[0],
                         "fused_segment_agg": total[1]}, "queries": out}


def host_agg_oracle(x: np.ndarray, q: float, first: np.ndarray) -> np.ndarray:
    """host_agg.py's percentile rule over the k groups of x [n, k]: linear
    interpolation of the sorted values at pos = first + q/100 * (n - 1),
    as lo * (1 - frac) + hi * frac. `first` is each group's offset in the
    module's sorted array (groups in global-id order, n rows each): the
    rounding of pos, and so frac, depends on it."""
    s = np.sort(x, axis=0)
    pos = first + (q / 100.0) * (s.shape[0] - 1)
    lo = np.floor(pos).astype(np.int64)
    hi = np.ceil(pos).astype(np.int64)
    frac = pos - lo
    k = np.arange(s.shape[1])
    return s[lo - first, k] * (1 - frac) + s[hi - first, k] * frac


def host_agg_phase(qe, sk, torch, grid) -> dict:
    """Check 5: median and percentile on the host beside an avg on K2,
    over the last hour by hostname; then a sparse query that carries a
    median (the host pass maps its rows onto the compact slots). Order
    statistics exact under host_agg.py's rule; avg rtol 1e-5."""
    from greptimedb_tpu_torch.query import partial_cache as pc

    per_hour = 3600 // STEP_S
    pts = HOURS * per_hour
    out = {}
    # host index -> the rank of its tag code in the region's dictionary
    rid = qe.catalog.table("public", "cpu").region_ids[0]
    codes = host_index(np.asarray(
        qe.region_engine.region(rid).registry.dict_array("hostname")))
    code_rank = np.empty(HOSTS, dtype=np.int64)
    code_rank[codes] = np.arange(HOSTS)
    lo = T0_MS + (HOURS - 1) * 3600 * 1000
    sql = ("SELECT hostname, avg(usage_user), median(usage_user), "
           f"percentile(usage_system, 95) FROM cpu WHERE ts >= {lo} "
           f"AND ts < {T0_MS + pts * STEP_S * 1000} "
           "GROUP BY hostname ORDER BY hostname")
    fb0 = pc.global_cache().events["fallback"]
    zero_launches(sk)
    res, ms = timed_query(qe, sql, torch)
    k1, k2 = launches(sk)
    path = qe.executor.last_path
    check(path == "dense_fused" and k2 >= 1 and k1 == 0,
          f"host aggs: {path}, K1 {k1}, K2 {k2}")
    check(pc.global_cache().events["fallback"] == fb0 + 1,
          "host aggs: the fold did not fall back (a typed decision)")
    host, avg, med, p95 = (np.asarray(c) for c in res.columns)
    order = host_order()
    check(np.array_equal(host_index(host), order),
          "host aggs: hostname keys")
    win = {f: grid[f][pts - per_hour:pts][:, order]
           for f in ("usage_user", "usage_system")}
    # the groups sort by tag code: host_<i>'s run starts at its code's
    # rank (every code is present), per_hour rows a run
    first = code_rank[order] * per_hour
    check(np.array_equal(med.astype(np.float64),
                         host_agg_oracle(win["usage_user"], 50.0, first)),
          "host aggs: median")
    check(np.array_equal(p95.astype(np.float64),
                         host_agg_oracle(win["usage_system"], 95.0, first)),
          "host aggs: p95")
    check(np.allclose(avg.astype(np.float64),
                      win["usage_user"].mean(axis=0), rtol=1e-5, atol=0),
          "host aggs: avg")
    out["by_host"] = {"last_path": path, "ms": ms, "k1_launches": k1,
                      "k2_launches": k2, "rows": res.num_rows}
    # a sparse key space (270 minutes x 4,001 > the 1M dense budget)
    minutes = 270
    lo = T0_MS + (pts * STEP_S * 1000) - minutes * 60_000
    sql = ("SELECT hostname, date_bin(INTERVAL '1 minute', ts) AS minute, "
           "median(usage_user), avg(usage_user) FROM cpu "
           f"WHERE ts >= {lo} AND ts < {T0_MS + pts * STEP_S * 1000} "
           "GROUP BY hostname, minute ORDER BY hostname, minute")
    zero_launches(sk)
    res, ms = timed_query(qe, sql, torch)
    k1, k2 = launches(sk)
    path = qe.executor.last_path
    check(path == "sparse_fused" and k2 == 1 and k1 == 0,
          f"sparse host aggs: {path}, K1 {k1}, K2 {k2}")
    host, _, med, avg = (np.asarray(c) for c in res.columns)
    check(res.num_rows == HOSTS * minutes, "sparse host aggs: rows")
    order = check_host_blocks(host, minutes, "sparse host aggs")
    x = grid["usage_user"][pts - minutes * 6:pts].reshape(minutes, 6, HOSTS)
    x = x[:, :, order].transpose(1, 2, 0).reshape(6, -1)  # [6, host*min]
    first = (np.repeat(code_rank[order], minutes) * minutes
             + np.tile(np.arange(minutes), HOSTS)) * 6
    check(np.array_equal(med.astype(np.float64),
                         host_agg_oracle(x, 50.0, first)),
          "sparse host aggs: median")
    check(np.allclose(avg.astype(np.float64), x.mean(axis=0), rtol=1e-5,
                      atol=0), "sparse host aggs: avg")
    out["sparse"] = {"last_path": path, "ms": ms, "k1_launches": k1,
                     "k2_launches": k2, "rows": res.num_rows,
                     **qe.executor.last_sparse_stats}
    log("host aggregates: " + json.dumps(out))
    return out


# ---- high cardinality: BASELINE config #5 ----------------------------------

#: bench.py's config #5 (bench.py:562-620): 1,000,000 tags x 10 points
HC_COMBOS = 1_000_000
HC_POINTS = 10
#: explicit flushes every this many rows (bench.py flushes every 30M rows
#: and at the end): each SST part stays inside one 8M-row device block,
#: the incremental fold's one-block-per-part gate
HC_FLUSH_ROWS = 4_000_000


def hc_phase(sk, torch) -> dict:
    """Check 4: the `hc` table (tag STRING, v DOUBLE, ts; append mode)
    built through RegionEngine.put with the WAL fsynced, in slices of up
    to 1 << 21 rows, flushed; then `SELECT tag, sum(v) FROM hc GROUP BY
    tag` with the cache off (dense_prepared: K1 at G = 1,000,002) and on
    (incremental_sparse: K2 a part), both held against numpy."""
    import shutil
    import tempfile

    from greptimedb_tpu_torch.datatypes import DictVector, RecordBatch

    root = tempfile.mkdtemp(prefix="chip_smoke_hc_")
    out = {}
    try:
        engine, qe = open_engine(root)
        qe.execute_one("CREATE TABLE hc (tag STRING, v DOUBLE, "
                       "ts TIMESTAMP(3) NOT NULL, TIME INDEX (ts), "
                       "PRIMARY KEY (tag)) WITH (append_mode = 'true')")
        info = qe.catalog.table("public", "hc")
        rid = info.region_ids[0]
        rng = np.random.default_rng(13)
        names = np.asarray([f"t{i:07d}" for i in range(HC_COMBOS)],
                           dtype=object)
        per_slice = max(1, (1 << 21) // HC_POINTS)
        vs = []
        rows = flushed = 0
        t = time.perf_counter()
        for c0 in range(0, HC_COMBOS, per_slice):
            c1 = min(c0 + per_slice, HC_COMBOS)
            n = (c1 - c0) * HC_POINTS
            v = rng.uniform(0, 1, n)
            vs.append(v)
            engine.put(rid, RecordBatch(info.schema, {
                "tag": DictVector(np.repeat(np.arange(c1 - c0,
                                                      dtype=np.int32),
                                            HC_POINTS), names[c0:c1]),
                "ts": np.tile(T0_MS + np.arange(HC_POINTS, dtype=np.int64)
                              * 1000, c1 - c0),
                "v": v}))
            rows += n
            if rows - flushed >= HC_FLUSH_ROWS:
                engine.flush(rid)
                flushed = rows
        engine.flush(rid)
        ingest_s = time.perf_counter() - t
        region = engine.region(rid)
        out["ingest"] = {"rows": rows, "seconds": ingest_s,
                         "rows_per_s": rows / ingest_s,
                         "sst_files": len(region.files),
                         "wal_fsyncs": engine.wal.sync_count}
        log("hc ingest: " + json.dumps(out["ingest"]))
        want = np.concatenate(vs).reshape(HC_COMBOS, HC_POINTS).sum(axis=1)
        del vs
        sql = "SELECT tag, sum(v) FROM hc GROUP BY tag"
        for on, want_path in ((False, "dense_prepared"),
                              (True, "incremental_sparse")):
            with partial_cache(on):
                runs = []
                for _ in range(3):
                    zero_launches(sk)
                    res, ms = timed_query(qe, sql, torch)
                    runs.append({"ms": ms, "launches": list(launches(sk)),
                                 "stats": qe.executor.last_partial_stats})
                path = qe.executor.last_path
                check(path == want_path, f"hc cache {on}: {path}")
                check(res.num_rows == HC_COMBOS, f"hc: {res.num_rows} rows")
                cols = dict(zip(res.names, res.columns))
                tags = np.asarray(cols["tag"]).astype(str)
                idx = np.char.lstrip(tags, "t").astype(np.int64)
                check(np.array_equal(np.sort(idx), np.arange(HC_COMBOS)),
                      "hc: tag keys")
                got = np.asarray(cols["sum(v)"], dtype=np.float64)
                check(np.allclose(got, want[idx], rtol=1e-5, atol=0),
                      f"hc cache {on}: sum max rel err "
                      f"{np.max(np.abs(got - want[idx]) / want[idx])}")
                cold, warm = runs[0], runs[1:]
                k1, k2 = cold["launches"]
                if on:
                    check(k1 == 0 and k2 == len(region.files),
                          f"hc cache on: cold launches {cold}")
                    check(all(w["launches"] == [0, 0]
                              and w["stats"]["part_hits"] == len(region.files)
                              for w in warm), f"hc cache on: warm {warm}")
                else:
                    check(k1 >= 1 and k2 == 0, f"hc cache off: {cold}")
                out["cache_on" if on else "cache_off"] = {
                    "last_path": path, "cold_ms": cold["ms"],
                    "warm_p50_ms": float(np.median([w["ms"] for w in warm])),
                    "cold_launches": cold["launches"],
                    "warm_launches": warm[-1]["launches"],
                    "groups": res.num_rows, "cold_stats": cold["stats"]}
                log(f"hc query, cache {'on' if on else 'off'}: "
                    + json.dumps(out["cache_on" if on else "cache_off"]))
        engine.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def dedup_phase(torch) -> None:
    """A non-append table with duplicate keys and tombstones, flushed
    between write batches so tombstones span files, then compacted; held
    against a Python last-write-wins oracle before and after."""
    import shutil
    import tempfile

    from greptimedb_tpu_torch.datatypes import DictVector, RecordBatch

    root = tempfile.mkdtemp(prefix="chip_smoke_dedup_")
    try:
        engine, qe = open_engine(root)
        qe.execute_one("CREATE TABLE t (host STRING, ts TIMESTAMP(3) NOT "
                       "NULL, v DOUBLE, TIME INDEX (ts), PRIMARY KEY (host))")
        info = qe.catalog.table("public", "t")
        rid = info.region_ids[0]
        rng = np.random.default_rng(SEED)
        live: dict = {}
        for i in range(40):
            n = 64
            hosts = rng.integers(0, 12, n)
            ts = rng.integers(0, 30, n) * 1000
            v = np.round(rng.uniform(0, 100, n), 1)
            cols = {"host": DictVector.encode([f"h{h}" for h in hosts]),
                    "ts": ts.astype(np.int64), "v": v}
            if rng.random() < 0.3:
                engine.delete(rid, RecordBatch(info.schema, cols))
                for h, t in zip(hosts, ts):
                    live.pop((f"h{h}", int(t)), None)
            else:
                engine.put(rid, RecordBatch(info.schema, cols))
                for h, t, x in zip(hosts, ts, v):
                    live[(f"h{h}", int(t))] = float(x)
            if i % 10 == 9:
                engine.flush(rid)
        per: dict = {}
        for (h, _), x in live.items():
            c, m = per.get(h, (0, -np.inf))
            per[h] = (c + 1, max(m, x))
        want_raw = sorted((h, t, x) for (h, t), x in live.items())
        want_agg = sorted((h, c, float(np.float32(m)))
                          for h, (c, m) in per.items())
        files = len(engine.region(rid).files)
        for state in ("flushed", "compacted"):
            if state == "compacted":
                qe.execute_one("ADMIN compact_table('t')")
            res = qe.execute_one("SELECT host, ts, v FROM t ORDER BY host, ts")
            got = [(str(h), int(t), float(x)) for h, t, x in res.rows()]
            check(got == want_raw, f"dedup {state} raw scan: {len(got)} "
                  f"rows, {len(want_raw)} expected")
            res = qe.execute_one("SELECT host, count(v), max(v) FROM t "
                                 "GROUP BY host ORDER BY host")
            got = [(str(h), int(c), float(m)) for h, c, m in res.rows()]
            check(got == want_agg, f"dedup {state} aggregate")
        log(f"dedup: {len(live)} live keys after tombstones over {files} "
            f"SSTs and a memtable, then one compacted file; last_path "
            f"{qe.executor.last_path}")
        engine.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---- PromQL: bench.py's prom_cpu and the `cpu` table ---------------------------


def window_index(grid_s, times, range_s):
    """Per eval time t, (i0, i1): the window (t - range_s, t] is
    grid_s[i0:i1] of the sorted sample times."""
    i0 = np.searchsorted(grid_s, times - range_s, side="right")
    i1 = np.searchsorted(grid_s, times, side="right")
    return i0, i1


def rate_oracle(mat, grid_s, times, range_s) -> np.ndarray:
    """sum(rate(m[range])) per eval time over `mat` [S, P] (every series
    on the grid `grid_s`): bench.py's promql_anchor.eval_rate
    (bench.py:518-541), with the counter zero-crossing limit on the start
    extrapolation that Prometheus applies (extrapolate_rate.rs) and the
    anchor leaves out. NaN where a window holds fewer than 2 samples."""
    out = np.full(len(times), np.nan)
    i0s, i1s = window_index(grid_s, times, range_s)
    for k, (t, i0, i1) in enumerate(zip(times, i0s, i1s - 1)):
        if i1 <= i0:
            continue
        first, last = mat[:, i0], mat[:, i1]
        tf, tl = grid_s[i0], grid_s[i1]
        sampled = tl - tf
        slope = (last - first) / sampled
        avg_gap = sampled / (i1 - i0)
        zero = np.where(slope > 0, first / np.where(slope > 0, slope, 1.0),
                        np.inf)
        head = np.minimum(tf - (t - range_s), zero)
        tail = t - tl
        duration = sampled \
            + np.where(head < 1.1 * avg_gap, head, avg_gap / 2) \
            + (tail if tail < 1.1 * avg_gap else avg_gap / 2)
        out[k] = float(np.sum(slope * duration)) / range_s
    return out


def window_means(mat, grid_s, times, range_s) -> np.ndarray:
    """[S, T] per-series window means (NaN where a window is empty)."""
    out = np.full((mat.shape[0], len(times)), np.nan)
    for k, (i0, i1) in enumerate(zip(*window_index(grid_s, times,
                                                   range_s))):
        if i1 > i0:
            out[:, k] = mat[:, i0:i1].sum(axis=1) / (i1 - i0)
    return out


def window_maxes(mat, grid_s, times, range_s) -> np.ndarray:
    out = np.full((mat.shape[0], len(times)), np.nan)
    for k, (i0, i1) in enumerate(zip(*window_index(grid_s, times,
                                                   range_s))):
        if i1 > i0:
            out[:, k] = mat[:, i0:i1].max(axis=1)
    return out


def check_close(got, want, rtol, what) -> float:
    """Equal NaN positions and values within rtol; the max relative
    error."""
    got = np.asarray(got, dtype=np.float64)
    check(got.shape == want.shape, f"{what}: shape {got.shape}, expected "
          f"{want.shape}")
    nan = np.isnan(want)
    check(np.array_equal(np.isnan(got), nan), f"{what}: NaN positions")
    err = np.abs(got[~nan] - want[~nan]) / np.maximum(np.abs(want[~nan]),
                                                      1e-300)
    worst = float(err.max()) if err.size else 0.0
    check(worst <= rtol, f"{what}: max rel err {worst} > {rtol}")
    return worst


def run_promql(name, fn, sk, torch, want_paths, paths_of) -> tuple:
    """One PromQL query: cold, then 5 warm runs, K2's launches in each
    (zeroed just before, read just after), the window path taken, a
    CUPTI profile and a cProfile breakdown of one more warm run.
    Returns the record and the cold result."""
    sk.fused_segment_agg.launches = 0
    sync(torch)
    t = time.perf_counter()
    res = fn()
    sync(torch)
    cold_ms = (time.perf_counter() - t) * 1e3
    k2_cold = sk.fused_segment_agg.launches
    paths = paths_of()
    warm, k2_warm = [], []
    for _ in range(5):
        sk.fused_segment_agg.launches = 0
        sync(torch)
        t = time.perf_counter()
        fn()
        sync(torch)
        warm.append((time.perf_counter() - t) * 1e3)
        k2_warm.append(sk.fused_segment_agg.launches)
    rec = {"cold_ms": cold_ms, "warm_p50_ms": float(np.median(warm)),
           "window_paths": paths, "k2_launches_cold": k2_cold,
           "k2_launches_warm": k2_warm}
    check(paths == want_paths, f"promql {name}: window paths {paths}, "
          f"expected {want_paths}")
    check(k2_cold == 1 and k2_warm == [1] * 5,
          f"promql {name}: K2 launches cold {k2_cold}, warm {k2_warm}; "
          "expected one a run")
    if torch.cuda.is_available():
        rec["profile"] = device_breakdown(fn, torch)
    rec["host"] = host_breakdown(fn)
    log(f"promql {name}: " + json.dumps(rec))
    return rec, res


def promql_cpu_phase(qe, sk, torch, grid) -> dict:
    """PromQL over the `cpu` table as ingested (4,000 hosts x 12 h at
    10 s, SSTs and a memtable), through PromqlEngine.eval_matrix at a
    5 min step with 1 h windows: max_over_time buckets 17.28 M rows into
    4,000 x 157 + 1 segments through K2 (the scatter flavour of
    window_stats); stddev(avg_over_time) takes the sums grid path and one
    K2 call with sumsq over the hosts; topk(5, max_over_time) keeps the
    five largest window maxes. Each held against numpy over `grid`."""
    from greptimedb_tpu_torch.promql.engine import PromqlEngine

    prom = PromqlEngine(qe)
    t0 = T0_MS // 1000
    t_end = t0 + HOURS * 3600
    times = t0 + np.arange(CPU_STEPS) * float(CPU_EVAL_STEP_S)
    user = grid["usage_user"][:POINTS].T  # [hosts, points]
    grid_s = t0 + np.arange(POINTS) * float(STEP_S)
    maxes = window_maxes(user, grid_s, times, CPU_RANGE_S)
    means = window_means(user, grid_s, times, CPU_RANGE_S)
    sel = f'cpu{{__field__="usage_user"}}[{CPU_RANGE_S // 3600}h]'
    queries = {
        "max_over_time": (f"max_over_time({sel})", ["window_stats"]),
        "stddev_avg_over_time": (f"stddev(avg_over_time({sel}))",
                                 ["sums"]),
        "topk_max_over_time": (f"topk(5, max_over_time({sel}))",
                               ["window_stats"]),
    }
    out = {}
    for name, (q, want_paths) in queries.items():
        rec, (got_times, m) = run_promql(
            name, lambda q=q: prom.eval_matrix(q, t0, t_end,
                                               float(CPU_EVAL_STEP_S)),
            sk, torch, want_paths, lambda: qe.executor.last_promql_paths)
        check(np.array_equal(got_times, times), f"promql {name}: times")
        vals = m.values.cpu().numpy()
        if name == "stddev_avg_over_time":
            check(m.labels == [{}], f"promql {name}: labels {m.labels[:3]}")
            rec["max_rel_err"] = check_close(
                vals[0], means.std(axis=0), 1e-9, f"promql {name}")
        else:
            hosts = host_index(np.asarray([lab["hostname"]
                                           for lab in m.labels]))
            check(np.array_equal(np.sort(hosts), np.arange(HOSTS)),
                  f"promql {name}: hostname labels")
            want = maxes[hosts]
            if name == "topk_max_over_time":
                thresh = -np.sort(-want, axis=0)[4]
                want = np.where(want >= thresh[None, :], want, np.nan)
                check(int((~np.isnan(vals)).sum()) >= 5 * CPU_STEPS,
                      f"promql {name}: fewer than 5 series a step")
            check(np.array_equal(np.isnan(vals), np.isnan(want))
                  and np.array_equal(vals[~np.isnan(vals)],
                                     want[~np.isnan(want)]),
                  f"promql {name}: window maxes differ from numpy")
        out[name] = rec
    return out


def prom_puts():
    """bench.py's bench_promql generator (bench.py:393-426), seed
    PROM_SEED: puts of (1 << 21) // PROM_SERIES points x PROM_SERIES
    counter series. Yields (put index, p0, p1, series codes, ts, values)
    in order."""
    rng = np.random.default_rng(PROM_SEED)
    points = PROM_HOURS * 3600 // PROM_STEP_S
    slice_points = max(1, (1 << 21) // PROM_SERIES)
    for i, p0 in enumerate(range(0, points, slice_points)):
        p1 = min(p0 + slice_points, points)
        npts = p1 - p0
        n = npts * PROM_SERIES
        codes = np.tile(np.arange(PROM_SERIES, dtype=np.int32), npts)
        ts = np.repeat(T0_MS + np.arange(p0, p1, dtype=np.int64)
                       * PROM_STEP_S * 1000, PROM_SERIES)
        base = np.repeat(np.arange(p0, p1, dtype=np.float64) * 50.0,
                         PROM_SERIES)
        yield i, p0, p1, codes, ts, base + rng.uniform(0, 50.0, n)


def prom_flush_every() -> int:
    points = PROM_HOURS * 3600 // PROM_STEP_S
    return max(1, points // (max(1, (1 << 21) // PROM_SERIES) * 8))


def prom_ingest(root):
    """bench.py's bench_promql ingest (bench.py:393-426) through
    RegionEngine.put with the WAL fsynced: puts of 209 points x 10,000
    series, a flush every 3 puts and one at the end. Returns the engines
    and the values as [series, points]."""
    from greptimedb_tpu_torch.datatypes import DictVector, RecordBatch

    engine, qe = open_engine(root)
    qe.execute_one(
        "CREATE TABLE prom_cpu (host STRING, val DOUBLE, "
        "ts TIMESTAMP(3) NOT NULL, TIME INDEX (ts), PRIMARY KEY (host)) "
        "WITH (append_mode = 'true')")
    info = qe.catalog.table("public", "prom_cpu")
    rid = info.region_ids[0]
    points = PROM_HOURS * 3600 // PROM_STEP_S
    names = np.asarray([f"s{i}" for i in range(PROM_SERIES)], dtype=object)
    flush_every = prom_flush_every()
    mat = np.empty((points, PROM_SERIES))
    rows = puts = 0
    t = time.perf_counter()
    for i, p0, p1, codes, ts, vals in prom_puts():
        mat[p0:p1] = vals.reshape(p1 - p0, PROM_SERIES)
        engine.put(rid, RecordBatch(info.schema, {
            "host": DictVector(codes, names), "ts": ts, "val": vals}))
        rows += len(vals)
        puts += 1
        if (i + 1) % flush_every == 0:
            engine.flush(rid)
    engine.flush(rid)
    ingest_s = time.perf_counter() - t
    region = engine.region(rid)
    log("prom_cpu ingest: " + json.dumps({
        "rows": rows, "seconds": ingest_s, "rows_per_s": rows / ingest_s,
        "puts": puts, "wal_fsyncs": engine.wal.sync_count,
        "sst_files": len(region.files), "sst_bytes": region.sst_bytes}))
    check(rows == PROM_SERIES * points, "prom_cpu ingested rows")
    return engine, qe, mat.T


def prom_queries(table: str) -> dict:
    """bench.py's three TQL EVAL queries over `table`: name -> (start,
    end, step, PromQL, window paths, window s)."""
    t0 = T0_MS // 1000
    t_end = t0 + PROM_HOURS * 3600
    step = PROM_EVAL_STEP_S
    rng_s = -(-max(120, step) // step) * step  # bench.py's window
    return {
        "rate_day": (t0, t_end, step, f"sum(rate({table}[{rng_s}s]))",
                     ["edges"], rng_s),
        "rate_tail": (t_end - 600, t_end, 60, f"sum(rate({table}[2m]))",
                      ["edges"], 120),
        "avg_day": (t0, t_end, step,
                    f"avg(avg_over_time({table}[{rng_s}s]))", ["sums"],
                    rng_s),
    }


def prom_check(name, res, mat, a, b, st, win) -> tuple:
    """A TQL EVAL result of prom_queries' `name` against numpy on `mat`
    [series, points] at rtol 1e-9: (steps, max rel err, values)."""
    grid_s = T0_MS // 1000 + np.arange(mat.shape[1]) * float(PROM_STEP_S)
    times = a + np.arange((b - a) // st + 1) * float(st)
    if name == "avg_day":
        want = window_means(mat, grid_s, times, win).mean(axis=0)
    else:
        want = rate_oracle(mat, grid_s, times, win)
    cols = dict(zip(res.names, res.columns))
    keep = ~np.isnan(want)
    check(np.array_equal(np.asarray(cols["ts"], dtype=np.int64),
                         (times[keep] * 1000).astype(np.int64)),
          f"promql {name}: eval steps")
    err = check_close(cols["value"], want[keep], 1e-9, f"promql {name}")
    return int(keep.sum()), err, np.asarray(cols["value"], dtype=np.float64)


def promql_phase(sk, torch) -> dict:
    """bench.py's config #3 at its full size: prom_cpu ingested to disk,
    then its three TQL EVAL queries through QueryEngine.execute_one on the
    card, each held against numpy on the generated matrix at rtol 1e-9:
    sum(rate(prom_cpu[360s])) over the day at a 360 s step (the edges
    path), the trailing 10 min sum(rate(prom_cpu[2m])) at 60 s, and
    avg(avg_over_time(prom_cpu[360s])) over the day (the sums path). Each
    query's label aggregation is one K2 call."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="chip_smoke_prom_")
    out = {}
    try:
        engine, qe, mat = prom_ingest(root)
        for name, (a, b, st, q, want_paths, win) in \
                prom_queries("prom_cpu").items():
            tql = f"TQL EVAL ({a}, {b}, '{st}s') {q}"
            rec, res = run_promql(
                name, lambda tql=tql: qe.execute_one(tql), sk, torch,
                want_paths, lambda: qe.executor.last_promql_paths)
            rec["steps"], rec["max_rel_err"], values = prom_check(
                name, res, mat, a, b, st, win)
            log(f"promql {name} check: {rec['steps']} steps, max rel err "
                f"{rec['max_rel_err']}")
            # the metric engine's phase holds its answers to these
            rec["values"] = values
            out[name] = rec
        if torch.cuda.is_available():
            log("promql max_memory_allocated: "
                f"{torch.cuda.max_memory_allocated()}")
        engine.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


# ---- the metric engine, the file engine and the index ---------------------------

#: logical tables beside prom_cpu_m in its physical region, as a
#: Prometheus deployment's other metrics: NEIGHBOUR_SERIES series x
#: NEIGHBOUR_HOURS h at 15 s each (the day's last hour)
METRIC_NEIGHBOURS = 20
NEIGHBOUR_SERIES = 1000
NEIGHBOUR_HOURS = 1
METRIC_DDL = ("CREATE TABLE {} (host STRING, val DOUBLE, "
              "ts TIMESTAMP(3) NOT NULL, TIME INDEX (ts), "
              "PRIMARY KEY (host)) ENGINE = metric")
#: the SQL panel over the logical table: 10,000 hosts x 24 hours
METRIC_PANEL = ("SELECT host, date_bin(INTERVAL '1 hour', ts) AS h, "
                "avg(val) FROM prom_cpu_m GROUP BY host, h")


def metric_ingest(root):
    """prom_ingest's puts (generator, seed, flushes) through
    RegionEngine.put on the logical region id of prom_cpu_m (ENGINE =
    metric), so every row goes through LogicalRegion.write into the
    database's physical region; neighbour i's one put (NEIGHBOUR_SERIES
    x NEIGHBOUR_HOURS h) follows prom_cpu_m's put i, so the flushed SSTs
    hold several logical tables' rows, as a deployment's do. Returns the
    engines, the values as [series, points], the logical region id and
    the ingest record."""
    from greptimedb_tpu_torch.datatypes import DictVector, RecordBatch

    engine, qe = open_engine(root)
    qe.execute_one(METRIC_DDL.format("prom_cpu_m"))
    for i in range(METRIC_NEIGHBOURS):
        qe.execute_one(METRIC_DDL.format(f"prom_n{i}"))
    info = qe.catalog.table("public", "prom_cpu_m")
    rid = info.region_ids[0]
    nbs = [qe.catalog.table("public", f"prom_n{i}")
           for i in range(METRIC_NEIGHBOURS)]
    points = PROM_HOURS * 3600 // PROM_STEP_S
    names = np.asarray([f"s{i}" for i in range(PROM_SERIES)], dtype=object)
    n_points = NEIGHBOUR_HOURS * 3600 // PROM_STEP_S
    n_codes = np.tile(np.arange(NEIGHBOUR_SERIES, dtype=np.int32), n_points)
    n_ts = np.repeat(T0_MS + np.arange(points - n_points, points,
                                       dtype=np.int64) * PROM_STEP_S * 1000,
                     NEIGHBOUR_SERIES)
    flush_every = prom_flush_every()
    mat = np.empty((points, PROM_SERIES))
    rows = n_rows = puts = 0

    def neighbour_put(i) -> int:
        nb = nbs[i]
        n_vals = np.repeat(np.arange(n_points) * 50.0, NEIGHBOUR_SERIES) \
            + np.random.default_rng(PROM_SEED + 1 + i).uniform(
                0, 50.0, len(n_codes))
        engine.put(nb.region_ids[0], RecordBatch(nb.schema, {
            "host": DictVector(n_codes, names), "ts": n_ts,
            "val": n_vals}))
        return len(n_vals)

    t = time.perf_counter()
    for i, p0, p1, codes, ts, vals in prom_puts():
        mat[p0:p1] = vals.reshape(p1 - p0, PROM_SERIES)
        engine.put(rid, RecordBatch(info.schema, {
            "host": DictVector(codes, names), "ts": ts, "val": vals}))
        rows += len(vals)
        puts += 1
        if i < METRIC_NEIGHBOURS:
            n_rows += neighbour_put(i)
        if (i + 1) % flush_every == 0:
            engine.flush(rid)
    for i in range(puts, METRIC_NEIGHBOURS):  # fewer puts than tables
        n_rows += neighbour_put(i)
    engine.flush(rid)
    ingest_s = time.perf_counter() - t
    phys = engine.region(engine.region(rid).meta.physical_region)
    rec = {"rows": rows, "neighbour_rows": n_rows, "seconds": ingest_s,
           "rows_per_s": (rows + n_rows) / ingest_s, "puts": puts,
           "wal_fsyncs": engine.wal.sync_count,
           "physical_ssts": len(phys.files),
           "physical_row_groups": sum(
               len(phys.sst_reader.footer(f)["row_groups"])
               for f in phys.files),
           "sst_bytes": phys.sst_bytes}
    log("prom_cpu_m ingest (metric engine): " + json.dumps(rec))
    check(rows == PROM_SERIES * points and n_rows == METRIC_NEIGHBOURS
          * NEIGHBOUR_SERIES * n_points, "prom_cpu_m ingested rows")
    return engine, qe, mat.T, rid, rec


def span_totals(rep) -> dict:
    """An ANALYZE report's spans by name: count and summed ms."""
    out: dict = {}
    for _depth, name, ms in rep["tree"]:
        c, t = out.get(name, (0, 0.0))
        out[name] = (c + 1, t + ms)
    return {k: {"count": c, "ms": t} for k, (c, t) in out.items()}


def pruned_since(region, before) -> dict:
    return {k: region.prune_stats[k] - before[k] for k in before}


def metric_phase(sk, torch, prom) -> dict:
    """BASELINE.json configs[2] over the metric engine: prom_cpu_m
    (10,000 series x 24 h at 15 s = 57,600,000 rows) and its 20
    neighbours (4,800,000 rows) in one physical region, which is not
    append-mode, so every scan deduplicates last-write-wins. The three
    TQL EVAL queries of promql_phase: each first as TQL ANALYZE (cold:
    the span tree, the physical SSTs and row groups scanned and pruned by
    the `__table` predicate), then three timed EVAL runs; one K2 launch a
    run, the window path, numpy at rtol 1e-9 and the plain prom_cpu's
    answers (`prom`) at rtol 1e-9. Then the SQL panel (host x hour avg,
    240,000 groups) as EXPLAIN ANALYZE (cold: spans, the sort-dedup's ms
    on the card) and three runs, against numpy at rtol 1e-5, and a
    neighbour's count whose scan must prune row groups."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="chip_smoke_metric_")
    out = {}
    try:
        if torch.cuda.is_available():
            torch.cuda.reset_peak_memory_stats()
        engine, qe, mat, rid, out["ingest"] = metric_ingest(root)
        phys = engine.region(engine.region(rid).meta.physical_region)
        k1 = k2 = 0
        for name, (a, b, st, q, want_paths, win) in \
                prom_queries("prom_cpu_m").items():
            tql = f"TQL EVAL ({a}, {b}, '{st}s') {q}"
            before = dict(phys.prune_stats)
            zero_launches(sk)
            sync(torch)
            t = time.perf_counter()
            rep = analyze_report(qe.execute_one(
                f"TQL ANALYZE ({a}, {b}, '{st}s') {q}"))
            sync(torch)
            cold_ms = (time.perf_counter() - t) * 1e3
            cold = launches(sk)
            paths = qe.executor.last_promql_paths
            pruned = pruned_since(phys, before)
            warm, warm_launches = [], []
            for _ in range(3):
                zero_launches(sk)
                res, ms = timed_query(qe, tql, torch)
                warm.append(ms)
                warm_launches.append(launches(sk))
            k1 += cold[0] + sum(w[0] for w in warm_launches)
            k2 += cold[1] + sum(w[1] for w in warm_launches)
            check(paths == want_paths,
                  f"metric {name}: window paths {paths}, expected "
                  f"{want_paths}")
            check(cold == (0, 1) and warm_launches == [(0, 1)] * 3,
                  f"metric {name}: K1 / K2 launches cold {cold}, warm "
                  f"{warm_launches}; expected one K2 a run")
            steps, err, values = prom_check(name, res, mat, a, b, st, win)
            plain_err = check_close(values, prom[name]["values"], 1e-9,
                                    f"metric {name} against prom_cpu")
            rec = {"cold_ms": cold_ms, "warm_ms": warm,
                   "plain_warm_p50_ms": prom[name]["warm_p50_ms"],
                   "window_paths": paths, "k2_launches_cold": cold[1],
                   "k2_launches_warm": [w[1] for w in warm_launches],
                   "pruning": pruned, "spans": span_totals(rep),
                   "steps": steps, "max_rel_err": err,
                   "max_rel_err_vs_prom_cpu": plain_err}
            log(f"metric {name}: " + json.dumps(rec))
            out[name] = rec

        # the SQL panel: the dedup of 57.6 M rows on the card, timed
        dedup_ms = []
        compute_dedup = qe.executor._compute_dedup

        def timed_dedup(scan, table):
            sync(torch)
            t = time.perf_counter()
            mask = compute_dedup(scan, table)
            sync(torch)
            dedup_ms.append((time.perf_counter() - t) * 1e3)
            return mask

        qe.executor._compute_dedup = timed_dedup
        try:
            before = dict(phys.prune_stats)
            zero_launches(sk)
            sync(torch)
            t = time.perf_counter()
            rep = analyze_report(qe.execute_one(
                "EXPLAIN ANALYZE " + METRIC_PANEL))
            sync(torch)
            cold_ms = (time.perf_counter() - t) * 1e3
            cold = launches(sk)
            pruned = pruned_since(phys, before)
            warm, warm_launches = [], []
            for _ in range(3):
                zero_launches(sk)
                res, ms = timed_query(qe, METRIC_PANEL, torch)
                warm.append(ms)
                warm_launches.append(launches(sk))
        finally:
            del qe.executor._compute_dedup
        k1 += cold[0] + sum(w[0] for w in warm_launches)
        k2 += cold[1] + sum(w[1] for w in warm_launches)
        path = qe.executor.last_path
        check(sum(cold) >= 1 and all(sum(w) >= 1 for w in warm_launches),
              f"metric panel: no kernel launched (cold {cold}, warm "
              f"{warm_launches})")
        check(len(dedup_ms) >= 1, "metric panel: no sort-dedup ran")
        cols = dict(zip(res.names, res.columns))
        per_hour = 3600 // PROM_STEP_S
        check(res.num_rows == PROM_SERIES * PROM_HOURS,
              f"metric panel: {res.num_rows} groups")
        hosts = np.asarray([int(h[1:]) for h in cols["host"]])
        hours = (np.asarray(cols["h"], dtype=np.int64) - T0_MS) // 3_600_000
        check(np.array_equal(np.sort(hosts * PROM_HOURS + hours),
                             np.arange(PROM_SERIES * PROM_HOURS)),
              "metric panel: group keys")
        want = mat.reshape(PROM_SERIES, PROM_HOURS, per_hour).mean(
            axis=2)[hosts, hours]
        got = np.asarray(cols["avg(val)"], dtype=np.float64)
        err = float(np.max(np.abs(got - want) / np.abs(want)))
        check(err <= 1e-5, f"metric panel: max rel err {err} > 1e-5")
        out["panel"] = {"cold_ms": cold_ms, "warm_ms": warm, "path": path,
                        "k1_launches_cold": cold[0],
                        "k2_launches_cold": cold[1],
                        "launches_warm": warm_launches, "pruning": pruned,
                        "dedup_ms": dedup_ms, "spans": span_totals(rep),
                        "ledger": rep["ledger"], "max_rel_err": err}
        log("metric panel: " + json.dumps(out["panel"]))

        # a neighbour: its scan must skip prom_cpu_m's SSTs or row groups
        before = dict(phys.prune_stats)
        zero_launches(sk)
        res, ms = timed_query(qe, "SELECT count(*), max(val) FROM prom_n7",
                              torch)
        n_launch = launches(sk)
        k1 += n_launch[0]
        k2 += n_launch[1]
        pruned = pruned_since(phys, before)
        n_points = NEIGHBOUR_HOURS * 3600 // PROM_STEP_S
        check(res.rows()[0][0] == NEIGHBOUR_SERIES * n_points
              and pruned["ssts_pruned"] + pruned["row_groups_pruned"] > 0,
              f"metric neighbour prom_n7: {res.rows()}, pruning {pruned}")
        out["neighbour"] = {"ms": ms, "pruning": pruned,
                            "launches": n_launch}
        log("metric neighbour prom_n7: " + json.dumps(out["neighbour"]))
        if torch.cuda.is_available():
            out["peak_device_bytes"] = torch.cuda.max_memory_allocated()
        out["k1_launches"], out["k2_launches"] = k1, k2
        log("metric phase: " + json.dumps({
            "k1_launches": k1, "k2_launches": k2,
            "peak_device_bytes": out.get("peak_device_bytes")}))
        engine.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def write_text_tables(root, grid, host_names) -> dict:
    """`cpu_1h` (grid [points, hosts] per field) as CSV (ts in ms, every
    field as Python's repr) and as gzip'd ndjson (the same values): the
    bytes plain Python and numpy give, laid out by the port's native
    number text and row assembly (native.number_text / text_rows): format
    -> (path, seconds)."""
    import gzip

    from greptimedb_tpu_torch import native

    lib = native.try_load()
    check(lib is not None, "the native library did not build")
    points, hosts = grid[FIELDS[0]].shape
    enc = [str(h).encode() for h in host_names]
    host_offs = np.zeros(len(enc) + 1, dtype=np.int64)
    host_offs[1:] = np.cumsum([len(h) for h in enc])
    cols = [(np.frombuffer(b"".join(enc), dtype=np.uint8), host_offs,
             np.tile(np.arange(hosts, dtype=np.int32), points)),
            (*lib.number_text(np.repeat(T0_MS + np.arange(
                points, dtype=np.int64) * STEP_S * 1000, hosts), "int"),
             None)]
    cols += [(*lib.number_text(grid[f].reshape(-1).astype(np.float64),
                               "repr"), None) for f in FIELDS]
    n = points * hosts
    out = {}
    t = time.perf_counter()
    path = os.path.join(root, "cpu_1h.csv")
    with open(path, "wb") as f:
        f.write((",".join(["hostname", "ts", *FIELDS]) + "\n").encode())
        f.write(lib.text_rows(cols, [""] + [","] * (len(cols) - 1)
                              + ["\n"], n))
    out["csv"] = (path, time.perf_counter() - t)
    t = time.perf_counter()
    pieces = ['{"hostname":"', '","ts":'] + [f',"{f}":' for f in FIELDS] \
        + ["}\n"]
    path = os.path.join(root, "cpu_1h.ndjson.gz")
    with open(path, "wb") as f:
        f.write(gzip.compress(lib.text_rows(cols, pieces, n),
                              compresslevel=1))
    out["ndjson.gz"] = (path, time.perf_counter() - t)
    return out


def file_engine_phase(sk, torch) -> dict:
    """External tables over `cpu_1h` (bench.py's generator at 4,000 hosts
    x 1 h at 10 s, seed SERVE_SEED: 1,440,000 rows, 10 DOUBLE fields),
    written once as CSV and once as gzip'd ndjson: CREATE EXTERNAL TABLE
    with the schema declared (CSV) and inferred (ndjson, whose CREATE
    parses the file; DESCRIBE must equal the native table's). CREATE and
    the first load (the hand-written parse where CREATE made none, and
    the coercion) are timed apart from the queries; single_groupby_1_1_1,
    cpu_max_all_8 and double_groupby_all then run twice over each, must
    equal the native table's rows and numpy, and the second run must be
    served from the mtime cache (no second parse)."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="chip_smoke_file_")
    out = {}
    try:
        engine, qe = open_engine(root)
        qe.execute_one(cpu_ddl())
        info = qe.catalog.table("public", "cpu")
        points = SERVE_HOURS * 3600 // STEP_S
        host_names = np.asarray([f"host_{i}" for i in range(HOSTS)],
                                dtype=object)
        fields = {f: [] for f in FIELDS}
        put_points(engine, info, np.random.default_rng(SERVE_SEED), 0,
                   points, host_names, fields)
        qe.execute_one("ADMIN flush_table('cpu')")
        grid = {f: np.concatenate(fields[f]).reshape(points, HOSTS)
                for f in FIELDS}
        files = write_text_tables(root, grid, host_names)
        decl = ", ".join(f"{f} DOUBLE" for f in FIELDS)
        create_ms = {}
        t = time.perf_counter()
        qe.execute_one(
            f"CREATE EXTERNAL TABLE cpu_csv (hostname STRING, "
            f"ts TIMESTAMP(3) TIME INDEX, {decl}, PRIMARY KEY (hostname)) "
            f"WITH (location = '{files['csv'][0]}', format = 'csv')")
        create_ms["cpu_csv"] = (time.perf_counter() - t) * 1e3
        # the inference parses the file; the first load reuses that parse
        t = time.perf_counter()
        qe.execute_one(f"CREATE EXTERNAL TABLE cpu_json WITH "
                       f"(location = '{files['ndjson.gz'][0]}')")
        create_ms["cpu_json"] = (time.perf_counter() - t) * 1e3
        check(qe.execute_one("DESCRIBE TABLE cpu_json").rows()
              == qe.execute_one("DESCRIBE TABLE cpu").rows(),
              "cpu_json: the inferred schema is not the native table's")
        queries = tsbs_queries()
        names = ("single_groupby_1_1_1", "cpu_max_all_8",
                 "double_groupby_all")
        native = {n: qe.execute_one(queries[n][0]) for n in names}
        k1 = k2 = 0
        for table, fmt in (("cpu_csv", "csv"), ("cpu_json", "ndjson.gz")):
            rid = qe.catalog.table("public", table).region_ids[0]
            region = engine.region(rid)
            t = time.perf_counter()
            region.scan()  # the parse (unless CREATE's) and the coercion
            load_ms = (time.perf_counter() - t) * 1e3
            rec = {"bytes": os.path.getsize(files[fmt][0]),
                   "write_s": files[fmt][1],
                   "create_ms": create_ms[table], "load_ms": load_ms,
                   "queries": {}}
            for n in names:
                sql = tsbs_queries(table)[n][0]
                runs = []
                for _ in range(2):
                    zero_launches(sk)
                    res, ms = timed_query(qe, sql, torch)
                    runs.append((ms, launches(sk)))
                check_result(n, res, grid, hours=SERVE_HOURS)
                want = native[n]
                check(res.names == want.names and len(res.rows())
                      == len(want.rows()), f"{table} {n}: shape")
                for a, b in zip(res.columns, want.columns):
                    a, b = np.asarray(a), np.asarray(b)
                    if a.dtype.kind == "f":
                        check(np.allclose(a, b, rtol=1e-6, atol=0),
                              f"{table} {n}: values differ from native")
                    else:
                        check(np.array_equal(a, b),
                              f"{table} {n}: keys differ from native")
                k1 += sum(r[1][0] for r in runs)
                k2 += sum(r[1][1] for r in runs)
                check(all(sum(r[1]) >= 1 for r in runs),
                      f"{table} {n}: no kernel launched")
                rec["queries"][n] = {
                    "ms": [r[0] for r in runs],
                    "launches": [r[1] for r in runs],
                    "path": qe.executor.last_path}
            rec["loads"], rec["cache_hits"] = region.loads, \
                region.cache_hits
            check(region.loads == 1 and region.cache_hits >= 2 * len(names),
                  f"{table}: parsed {region.loads} times, "
                  f"{region.cache_hits} cache hits")
            log(f"file engine {table} ({fmt}): " + json.dumps(rec))
            out[table] = rec
        out["k1_launches"], out["k2_launches"] = k1, k2
        engine.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def index_phase(qe, sk, torch, grid) -> dict:
    """The per-file index on the main path's `cpu` table: its SSTs carry
    puffin indexes. A `WHERE hostname IN (...)` aggregate with the
    region's decoded parts and scans dropped must decode exactly the row
    groups the index selects (the footers' row counts), prune the rest,
    and match numpy."""
    from greptimedb_tpu_torch.storage.index import InSet

    info = qe.catalog.table("public", "cpu")
    region = qe.region_engine.region(info.region_ids[0])
    picks = [1, HOSTS // 2, HOSTS - 1]
    names = [f"host_{i}" for i in picks]
    sql = ("SELECT hostname, max(usage_user), avg(usage_system), count(*) "
           f"FROM cpu WHERE hostname IN ({', '.join(repr(n) for n in names)})"
           " GROUP BY hostname ORDER BY hostname")
    preds = {"hostname": (InSet.of(names),)}
    want_groups = total_groups = 0
    for fid in region.files:
        counts = [rg["rows"] for rg in
                  region.sst_reader.footer(fid)["row_groups"]]
        sel = region.sst_reader.index_applier.apply(fid, preds, counts)
        total_groups += len(counts)
        want_groups += len(counts) if sel is None else len(sel)
    with region._lock:
        region._part_cache.clear()
        region._part_cache_bytes = 0
        region._scan_cache.clear()
    before = dict(region.prune_stats)
    zero_launches(sk)
    with partial_cache(False):
        res, ms = timed_query(qe, sql, torch)
    n_launch = launches(sk)
    pruned = pruned_since(region, before)
    decoded = pruned["row_groups"] - pruned["row_groups_pruned"]
    check(decoded == want_groups and pruned["row_groups_pruned"] > 0,
          f"index: decoded {decoded} row groups, the index selects "
          f"{want_groups} of {total_groups} ({pruned})")
    rows = res.rows()
    order = np.argsort(np.asarray(names))
    points = grid["usage_user"].shape[0]
    for row, k in zip(rows, order):
        h = picks[k]
        check(row[0] == names[k] and row[3] == points
              and row[1] == f32_exact(grid["usage_user"][:, h].max())
              and np.isclose(row[2], grid["usage_system"][:, h].mean(),
                             rtol=1e-5, atol=0),
              f"index: {row} differs from numpy for {names[k]}")
    rec = {"ms": ms, "row_groups": total_groups, "decoded": decoded,
           "pruning": pruned, "ssts": len(region.files),
           "k1_launches": n_launch[0], "k2_launches": n_launch[1],
           "path": qe.executor.last_path}
    log("index on cpu, hostname IN (3 hosts): " + json.dumps(rec))
    return rec


# ---- phase 4: streaming beyond device memory -----------------------------------


def stream_sql() -> str:
    avg_list = ", ".join(f"avg({f})" for f in FIELDS)
    return ("SELECT date_bin(INTERVAL '1 hour', ts) AS hour, hostname, "
            f"{avg_list} FROM cpu_big GROUP BY hour, hostname")


def stream_rows_for(root) -> tuple:
    """The row count the disk at `root` holds: STREAM_ROWS, or fewer
    (whole puts) when its SSTs, a WAL of STREAM_FLUSH_EVERY puts and 2 GB
    of margin do not fit. Returns (rows, the cut or None)."""
    import shutil

    free = shutil.disk_usage(root).free
    put_rows = STREAM_PUT_POINTS * STREAM_HOSTS
    wal = 2 * STREAM_FLUSH_EVERY * put_rows * STREAM_ROW_BYTES
    fit = (free - wal - (2 << 30)) // STREAM_ROW_BYTES
    if fit >= STREAM_ROWS:
        return STREAM_ROWS, None
    rows = max(fit // put_rows, 1) * put_rows
    return rows, (f"disk: {free} bytes free at {root} hold {rows} of "
                  f"{STREAM_ROWS} rows")


def stream_ingest(root, rows_target):
    """bench.py's cpu_big ingest through RegionEngine.put on a disk-backed
    engine, the WAL fsynced, a flush every STREAM_FLUSH_EVERY puts and one
    at the end (the memtable never reaches the auto-flush). The oracle
    accumulates float64 sums and counts per (hour, host) with np.bincount
    over each put, so it never holds the rows. Returns (engine, qe, rows,
    sums [hours * hosts, F], counts, the cut or None)."""
    from greptimedb_tpu_torch.catalog import Catalog, FileKv
    from greptimedb_tpu_torch.datatypes import DictVector, RecordBatch
    from greptimedb_tpu_torch.query import QueryEngine
    from greptimedb_tpu_torch.storage import EngineConfig, RegionEngine

    engine = RegionEngine(EngineConfig(
        data_dir=os.path.join(root, "data"), wal_sync=True,
        flush_threshold_bytes=1 << 40), device=DEVICE)
    qe = QueryEngine(Catalog(FileKv(os.path.join(root, "catalog.json"))),
                     engine, device=DEVICE)
    field_defs = ", ".join(f"{f} DOUBLE" for f in FIELDS)
    qe.execute_one(
        f"CREATE TABLE cpu_big (hostname STRING, ts TIMESTAMP(3) NOT NULL, "
        f"{field_defs}, TIME INDEX (ts), PRIMARY KEY (hostname)) "
        "WITH (append_mode = 'true')")
    info = qe.catalog.table("public", "cpu_big")
    rid = info.region_ids[0]
    rng = np.random.default_rng(STREAM_SEED)
    names = np.asarray([f"host_{i}" for i in range(STREAM_HOSTS)],
                       dtype=object)
    points = rows_target // STREAM_HOSTS
    g = -(-points * STEP_S // 3600) * STREAM_HOSTS
    sums = np.zeros((g, len(FIELDS)))
    counts = np.zeros(g, dtype=np.int64)
    rows = puts = 0
    cut = None
    engine_s = 0.0
    t_wall = time.perf_counter()
    for i, p0 in enumerate(range(0, points, STREAM_PUT_POINTS)):
        if puts >= STREAM_MIN_PUTS and \
                time.perf_counter() - T_START > STREAM_INGEST_DEADLINE_S:
            cut = (f"time: the ingest stopped at {rows} rows, "
                   f"{STREAM_INGEST_DEADLINE_S} s into the run")
            break
        p1 = min(p0 + STREAM_PUT_POINTS, points)
        n = (p1 - p0) * STREAM_HOSTS
        codes = np.tile(np.arange(STREAM_HOSTS, dtype=np.int32), p1 - p0)
        ts = np.repeat(T0_MS + np.arange(p0, p1, dtype=np.int64)
                       * STEP_S * 1000, STREAM_HOSTS)
        cols = {"hostname": DictVector(codes, names), "ts": ts}
        gid = (ts - T0_MS) // 3_600_000 * STREAM_HOSTS + codes
        counts += np.bincount(gid, minlength=g)
        for j, f in enumerate(FIELDS):
            cols[f] = rng.uniform(0.0, 100.0, n)
            sums[:, j] += np.bincount(gid, weights=cols[f], minlength=g)
        t = time.perf_counter()
        engine.put(rid, RecordBatch(info.schema, cols))
        rows += n
        puts += 1
        if (i + 1) % STREAM_FLUSH_EVERY == 0:
            engine.flush(rid)
        engine_s += time.perf_counter() - t
    t = time.perf_counter()
    engine.flush(rid)
    engine_s += time.perf_counter() - t
    region = engine.region(rid)
    log("stream ingest (cpu_big): " + json.dumps({
        "rows": rows, "target_rows": STREAM_ROWS, "puts": puts,
        "engine_seconds": engine_s, "rows_per_s": rows / engine_s,
        "wall_seconds_with_oracle": time.perf_counter() - t_wall,
        "wal_fsyncs": engine.wal.sync_count,
        "sst_files": len(region.files), "sst_bytes": region.sst_bytes,
        "memtable_rows": region.memtable.num_rows, "cut": cut}))
    return engine, qe, rows, sums, counts, cut


def stream_blocks(region, block: int) -> int:
    """The blocks a stream of the whole region folds: each file's chunks
    of 8 row groups (Region.scan_stream's groups_per_chunk) in blocks of
    `block` rows, then the memtable's rows."""
    n = 0
    for meta in region.files.values():
        rgs = region.sst_reader.footer(meta.file_id)["row_groups"]
        for i in range(0, len(rgs), 8):
            n += -(-sum(rg["rows"] for rg in rgs[i:i + 8]) // block)
    return n + -(-region.memtable.num_rows // block)


def check_stream_result(res, sums, counts, hours, what) -> float:
    """280,000 (hour, host) rows, each avg within rtol 1e-5 of the float64
    oracle; returns the largest relative error."""
    check(res.num_rows == STREAM_HOSTS * hours,
          f"{what}: {res.num_rows} rows, expected {STREAM_HOSTS * hours}")
    cols = dict(zip(res.names, res.columns))
    hour = (np.asarray(cols["hour"], dtype=np.int64) - T0_MS) // 3_600_000
    gid = hour * STREAM_HOSTS + host_index(np.asarray(cols["hostname"]))
    check(np.array_equal(np.sort(gid), np.arange(STREAM_HOSTS * hours)),
          f"{what}: (hour, hostname) keys")
    worst = 0.0
    for j, f in enumerate(FIELDS):
        want = sums[gid, j] / counts[gid]
        got = np.asarray(cols[f"avg({f})"], dtype=np.float64)
        err = float(np.max(np.abs(got - want) / np.abs(want)))
        check(np.allclose(got, want, rtol=1e-5, atol=0),
              f"{what} avg({f}): max rel err {err}")
        worst = max(worst, err)
    return worst


def proc_status_bytes(key: str) -> int:
    """A size line of /proc/self/status (VmRSS: resident now)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith(key + ":"):
                return int(line.split()[1]) * 1024
    raise CheckFailed(f"/proc/self/status has no {key}")


class rss_peak:
    """This process's resident set before a block and its peak during it,
    sampled every 10 ms on a thread joined when the block ends."""

    def __enter__(self):
        import threading

        self.before = self.peak = proc_status_bytes("VmRSS")
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def _sample(self):
        while not self._stop.wait(0.01):
            self.peak = max(self.peak, proc_status_bytes("VmRSS"))

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, proc_status_bytes("VmRSS"))
        return False


def mem_available() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    return 0


def stream_phase(sk, torch, lib=None) -> dict:
    """BASELINE.json configs[1] at its full size: cpu_big ingested to disk,
    then its double-groupby-all through QueryEngine.execute_one on the
    card with the partial cache at its default. Each run (cold, then warm
    p50 of 3) must stream (`stream_prepared`), launch K1 once a block and
    K2 never, call Region.scan never, leave the hot set as it was, keep
    its host bytes in flight within one chunk and depth + 2 blocks, and
    hold every avg to the oracle at rtol 1e-5. Then one torch.profiler
    run and one cProfile run, and the materialized route (cold and warm,
    cache off: dense_prepared over the hot set) on the same table, held
    to the same oracle, unless the host lacks the memory for it."""
    import shutil
    import tempfile

    from greptimedb_tpu_torch import config

    base = max((tempfile.gettempdir(), HERE),
               key=lambda d: shutil.disk_usage(d).free)
    root = tempfile.mkdtemp(prefix="chip_smoke_stream_", dir=base)
    out: dict = {}
    try:
        rows_target, disk_cut = stream_rows_for(root)
        engine, qe, rows, sums, counts, time_cut = stream_ingest(
            root, rows_target)
        out["cut"] = disk_cut or time_cut
        hours = -(-(rows // STREAM_HOSTS) * STEP_S // 3600)
        region = engine.region(qe.catalog.table(
            "public", "cpu_big").region_ids[0])
        check(region.memtable.num_rows == 0 and len(region.files) >= 2,
              "cpu_big: the ingest left no flushed files")
        threshold = config.stream_threshold_rows()
        if rows < threshold:  # only after a cut: stream what landed
            threshold = rows
            log(f"stream threshold lowered to {rows} rows for the cut")
        scans = []
        real_scan = region.scan

        def counting_scan(*a, **kw):
            scans.append(1)
            return real_scan(*a, **kw)

        region.scan = counting_scan
        sql = stream_sql()
        want_blocks = stream_blocks(region, config.stream_block_rows())
        cache = qe.executor.cache
        cuda = torch.cuda.is_available()
        runs = []
        with env_value("GREPTIMEDB_TPU_STREAM_THRESHOLD_ROWS",
                       str(threshold)):
            for i in range(4):
                zero_launches(sk)
                if lib is not None:
                    k1_stats(lib, reset=True)
                resident = cache.resident_bytes
                if cuda:
                    torch.cuda.reset_peak_memory_stats()
                with rss_peak() as rss:
                    res, ms = timed_query(qe, sql, torch)
                st = qe.executor.last_stream_stats
                run = {"ms": ms, "rows_per_s": rows / ms * 1e3,
                       "host_rss_before": rss.before,
                       "host_rss_peak": rss.peak,
                       "last_path": qe.executor.last_path,
                       "k1_launches": sk.segment_sum.launches,
                       "k2_launches": sk.fused_segment_agg.launches,
                       "max_memory_allocated":
                       torch.cuda.max_memory_allocated() if cuda else None,
                       "resident_bytes_delta": cache.resident_bytes
                       - resident, "region_scans": len(scans),
                       "stream": st}
                if lib is not None and i == 0:
                    run["k1_counters"] = k1_stats(lib, reset=True)
                what = "stream cold" if i == 0 else f"stream warm {i}"
                check(run["last_path"] == "stream_prepared",
                      f"{what}: last_path {run['last_path']}")
                check(run["k1_launches"] == want_blocks == st["blocks"],
                      f"{what}: K1 {run['k1_launches']} launches, "
                      f"{st['blocks']} blocks, {want_blocks} expected")
                check(run["k2_launches"] == 0, f"{what}: K2 launched")
                check(not scans, f"{what}: Region.scan was called")
                check(run["resident_bytes_delta"] == 0,
                      f"{what}: the hot set changed")
                check(st["peak_host_bytes"] <= st["chunk_bytes_max"]
                      + (st["depth"] + 2) * st["block_bytes_max"],
                      f"{what}: {st['peak_host_bytes']} host bytes in flight")
                run["max_rel_err"] = check_stream_result(
                    res, sums, counts, hours, what)
                log(f"{what}: " + json.dumps(run))
                runs.append(run)
            if cuda:
                log("stream profile (one warm run, profiler on): "
                    + json.dumps(device_breakdown(
                        lambda: qe.execute_one(sql), torch)))
            log("stream host breakdown (one warm run, every thread): "
                + json.dumps(host_breakdown(
                    lambda: qe.execute_one(sql))))
            check(qe.executor.last_path == "stream_prepared" and not scans,
                  "stream: the profiled runs left the streaming route")
        out["rows"] = rows
        out["cold"] = runs[0]
        out["warm_p50_ms"] = float(np.median([r["ms"] for r in runs[1:]]))
        log("stream summary: " + json.dumps({
            "rows": rows, "blocks": want_blocks, "cold_ms": runs[0]["ms"],
            "warm_p50_ms": out["warm_p50_ms"],
            "warm_rows_per_s": rows / out["warm_p50_ms"] * 1e3,
            "h2d_bytes": runs[0]["stream"]["h2d_bytes"],
            "max_memory_allocated": runs[0]["max_memory_allocated"],
            "peak_host_bytes": runs[0]["stream"]["peak_host_bytes"],
            "host_rss_before": runs[0]["host_rss_before"],
            "host_rss_peak": runs[0]["host_rss_peak"],
            "cut": out["cut"]}))
        from greptimedb_tpu_torch.storage import scan_pool

        cold = runs[0]["stream"]
        out["decode"] = {
            "decode_workers": scan_pool.resolve(region.decode_threads,
                                                len(region.files)),
            "sst_files": len(region.files), "cold_ms": runs[0]["ms"],
            "producer_busy_s": cold["produce_s"],
            "consumer_wait_s": cold["wait_s"]}
        # the serial decode's figures at this depth (PERF.md §5): 17.6-18.8
        # s cold, the producer busy 10.8-11.7 s, the SST read 4.2-4.5 s
        log("stream decode (parallel files, beside the serial decode's "
            "17.6-18.8 s cold, producer 10.8-11.7 s busy): "
            + json.dumps(out["decode"]))

        # the materialized route on the same table, for comparison
        avail, need = mem_available(), 3 * rows * STREAM_ROW_BYTES
        if avail < need:
            out["materialized"] = {"skipped": f"MemAvailable {avail} < "
                                   f"3 x the scan's {need // 3} bytes"}
            log("stream materialized comparison skipped: "
                + out["materialized"]["skipped"])
        else:
            mat = {}
            with partial_cache(False), env_value(
                    "GREPTIMEDB_TPU_STREAM_THRESHOLD_ROWS", str(1 << 62)):
                for tag in ("cold", "warm"):
                    zero_launches(sk)
                    if cuda:
                        torch.cuda.reset_peak_memory_stats()
                    with rss_peak() as rss:
                        res, ms = timed_query(qe, sql, torch)
                    rec = {"ms": ms, "last_path": qe.executor.last_path,
                           "host_rss_before": rss.before,
                           "host_rss_peak": rss.peak,
                           "k1_launches": sk.segment_sum.launches,
                           "k2_launches": sk.fused_segment_agg.launches,
                           "max_memory_allocated":
                           torch.cuda.max_memory_allocated() if cuda
                           else None,
                           "resident_bytes": cache.resident_bytes}
                    check(rec["last_path"] == "dense_prepared",
                          f"materialized {tag}: {rec['last_path']}")
                    rec["max_rel_err"] = check_stream_result(
                        res, sums, counts, hours, f"materialized {tag}")
                    log(f"stream materialized {tag} (cache off): "
                        + json.dumps(rec))
                    mat[tag] = rec
            out["materialized"] = mat
        del res
        engine.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


# ---- serving: the HTTP server under bench.py's qps traffic --------------------

#: bench.py's two serving configurations: qps_single_groupby (bench_qps,
#: bench.py:1625-1700: 50 keep-alive clients, 2,000 requests) and
#: qps_mixed_tenants (bench_qps_mixed, bench.py:1917-2070: dash, ops and
#: analytics, 10 clients a tenant, 3,000 requests)
QPS_CLIENTS = 50
QPS_REQUESTS = 2000
MIXED_CLIENTS = 10
MIXED_REQUESTS = 3000
#: the mixed traffic on the 17.28 M-row table is cut to this many
#: requests: its ops statements filter the whole table's tag column on
#: the host (265-296 ms a warm run, 14-26 qps on the card), so bench.py's
#: 3,000 requests and their serial checks would take minutes; the cut is
#: printed
MIXED_REQUESTS_CPU = 150
#: the second data dir: bench.py's generator at HOSTS x 1 h at 10 s
#: (1.44 M rows, under the batcher's 4 Mi-row stacking bound)
SERVE_HOURS = 1
SERVE_SEED = 31
#: the share of a traffic's requests replayed under torch.profiler for
#: the device's idle share
PROFILED_SHARE = 10
BATCH_KINDS = ("join", "coalesced", "vmapped", "stacked", "serial_fallback")


def single_groupby_sql() -> str:
    """bench_qps's statement: single-groupby-1-1-1 without ORDER BY."""
    return (f"SELECT date_bin(INTERVAL '1 minute', ts) AS minute, "
            f"max(usage_user) FROM cpu WHERE hostname = 'host_1' "
            f"AND ts >= {T0_MS} AND ts < {T0_MS + 3600 * 1000} "
            f"GROUP BY minute")


def mixed_tenants(hours: int) -> list:
    """bench_qps_mixed's three tenants over a table of `hours` hours:
    (name, request index -> SQL)."""
    hour_ms = 3600 * 1000

    def dash(i):
        lo = T0_MS + (i % max(1, hours - 1)) * hour_ms
        return (f"SELECT date_bin(INTERVAL '1 minute', ts) AS minute, "
                f"max(usage_user) FROM cpu "
                f"WHERE hostname = 'host_{i % min(HOSTS, 64)}' "
                f"AND ts >= {lo} AND ts < {lo + hour_ms} GROUP BY minute")

    def ops(i):
        return (f"SELECT last_value(usage_user ORDER BY ts) FROM cpu "
                f"WHERE hostname = 'host_{i % min(HOSTS, 256)}'")

    def analytics(i):
        lo = T0_MS + (i % max(1, hours - 1)) * hour_ms
        return (f"SELECT hostname, max(usage_user), avg(usage_system) "
                f"FROM cpu WHERE ts >= {lo} AND ts < {lo + hour_ms} "
                f"GROUP BY hostname")

    return [("dash", dash), ("ops", ops), ("analytics", analytics)]


def drive(port, tenants, clients, total) -> dict:
    """bench.py's client loop: `clients` keep-alive connections a tenant,
    `total` requests split evenly. Returns per-tenant latencies (s) and
    error counts, the wall time, the requests done, and every statement's
    distinct response bodies (cut before `execution_time_ms`)."""
    import http.client
    import threading
    import urllib.parse

    per_client = max(1, total // (len(tenants) * clients))
    lat = {name: [] for name, _ in tenants}
    errors = {name: 0 for name, _ in tenants}
    bodies: dict = {}
    first_error: list = []
    lock = threading.Lock()

    def client(name, gen, i):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        headers = {"Content-Type": "application/x-www-form-urlencoded"}
        if name != "default":
            headers["X-Greptime-Tenant"] = name
        mine, err, got = [], 0, []
        try:
            for k in range(per_client):
                sql = gen(i * per_client + k)
                body = urllib.parse.urlencode({"sql": sql})
                t0 = time.perf_counter()
                try:
                    conn.request("POST", "/v1/sql", body=body,
                                 headers=headers)
                    resp = conn.getresponse()
                    data = resp.read()
                except Exception as e:  # noqa: BLE001 — counted, reported
                    err += 1
                    first_error.append(repr(e))
                    conn.close()
                    continue
                if resp.status != 200:
                    err += 1
                    first_error.append(data[:300].decode(errors="replace"))
                    continue
                mine.append(time.perf_counter() - t0)
                got.append((sql, data[:data.rindex(b', "execution_time_ms"')]))
        finally:
            conn.close()
            with lock:
                lat[name].extend(mine)
                errors[name] += err
                for sql, b in got:
                    bodies.setdefault(sql, set()).add(b)

    threads = [threading.Thread(target=client, args=(name, gen, i))
               for name, gen in tenants for i in range(clients)]
    t = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    wall = time.perf_counter() - t
    return {"lat": lat, "errors": errors, "wall_s": wall, "bodies": bodies,
            "requests": sum(len(v) for v in lat.values()),
            "first_error": first_error[:1]}


def served_oracle(sql, res, grid) -> None:
    """The dash, single-groupby and ops statements' serial results against
    the numpy grid ([points, hosts] per field): a minute's max of one
    host's hour, and a host's last value, as the f32 kernels see them."""
    import re

    cols = {n: np.asarray(c) for n, c in zip(res.names, res.columns)}
    host = int(re.search(r"hostname = 'host_(\d+)'", sql).group(1))
    if "last_value" in sql:
        check(res.num_rows == 1 and np.array_equal(
            cols[res.names[0]].astype(np.float64),
            f32_exact(grid["usage_user"][-1:, host])), f"served {sql}")
        return
    lo = int(re.search(r"ts >= (\d+)", sql).group(1))
    p0 = (lo - T0_MS) // (STEP_S * 1000)
    want = grid["usage_user"][p0:p0 + 3600 // STEP_S, host].reshape(
        60, -1).max(axis=1)
    check(np.array_equal(cols["minute"], lo + np.arange(60) * 60_000)
          and np.array_equal(cols["max(usage_user)"].astype(np.float64),
                             f32_exact(want)), f"served {sql}")


def check_served(qe, bodies, grid) -> dict:
    """Every distinct response body against its statement's serial result
    on the same engine, run once with batching off (max, min and last
    exactly, avg to rtol 1e-5); the dash, single-groupby and ops serial
    results against the numpy grid."""
    from greptimedb_tpu_torch.servers.encode import json_rows

    n = 0
    for sql, prefixes in bodies.items():
        with qe.concurrency.suppress_batching():
            res = qe.execute_one(sql)
        if "hostname = " in sql:
            served_oracle(sql, res, grid)
        want = json_rows(res)
        for p in prefixes:
            rec = json.loads(p + b"}")["output"][0]["records"]
            names = [c["name"] for c in rec["schema"]["column_schemas"]]
            got = rec["rows"]
            check(names == list(res.names) and len(got) == len(want),
                  f"served {sql}: {len(got)} rows, serial {len(want)}")
            for j, name in enumerate(names):
                a = [r[j] for r in want]
                b = [r[j] for r in got]
                if name.startswith("avg("):
                    ok = all((x is None and y is None) or (
                        x is not None and y is not None
                        and abs(x - y) <= 1e-5 * abs(x)) for x, y in zip(a, b))
                else:
                    ok = a == b
                check(ok, f"served {sql}: column {name} differs from the "
                      "serial result")
            n += 1
    return {"statements": len(bodies), "bodies": n}


def serve_traffic(qe, sk, torch, what, tenants, clients, total, grid,
                  bench_total=None) -> dict:
    """One traffic against an in-process HttpServer on `qe`: a warm
    request a shape, the timed run (kernel counts zeroed just before and
    read just after; every vmapped group's own K2 calls counted on its
    thread), a profiled burst of 1/PROFILED_SHARE of the requests for the
    device's idle share, then every response against its serial result.
    The server and the plane's encode workers are stopped and must leave
    no thread behind."""
    import threading

    from greptimedb_tpu_torch.query import vmapped as vm
    from greptimedb_tpu_torch.servers import HttpServer
    from greptimedb_tpu_torch.utils import metrics as m

    t_phase = time.perf_counter()
    before = set(threading.enumerate())
    cuda = torch.cuda.is_available() and DEVICE is None
    tls = threading.local()
    groups: list = []
    real_k2, real_vm = sk.fused_segment_agg, vm.run_vmapped

    def k2_spy(*a, **kw):
        tls.k2 = getattr(tls, "k2", 0) + 1
        return real_k2(*a, **kw)

    def vm_spy(executor, sel, info, pspecs, member_values):
        tls.k2 = 0
        out = real_vm(executor, sel, info, pspecs, member_values)
        groups.append((len(member_values), tls.k2))
        return out

    srv = HttpServer(qe, port=0)
    port = srv.start()
    try:
        for _, gen in tenants:  # one warm request a shape, as bench.py
            warm = drive(port, [("default", gen)], 1, 1)
            check(warm["requests"] == 1,
                  f"{what}: warm request failed {warm['first_error']}")
        ev0 = {k: m.QUERY_BATCH_EVENTS.get(event=k) for k in BATCH_KINDS}
        w0 = (m.VMAP_BATCH_WIDTH.total_sum(), m.VMAP_BATCH_WIDTH.total_count())
        lane0 = lane_snapshot()
        sync(torch)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        zero_launches(sk)
        # the wrapper counts on the module's name: the spy carries the
        # count while it stands in, and hands it back
        k2_spy.launches = real_k2.launches
        sk.fused_segment_agg, vm.run_vmapped = k2_spy, vm_spy
        try:
            run = drive(port, tenants, clients, total)
            sync(torch)
        finally:
            sk.fused_segment_agg, vm.run_vmapped = real_k2, real_vm
            real_k2.launches = k2_spy.launches
        k1, k2 = launches(sk)
        lane = lane_report(lane0, run["requests"])
        peak = torch.cuda.max_memory_allocated() if cuda else None
        events = {k: m.QUERY_BATCH_EVENTS.get(event=k) - ev0[k]
                  for k in BATCH_KINDS}
        wsum = m.VMAP_BATCH_WIDTH.total_sum() - w0[0]
        wcount = m.VMAP_BATCH_WIDTH.total_count() - w0[1]
        burst_n = max(total // PROFILED_SHARE, len(tenants) * clients)
        if cuda:
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t = time.perf_counter()
                burst = drive(port, tenants, clients, burst_n)
                torch.cuda.synchronize()
                burst_wall = time.perf_counter() - t
            device_ms = sum(e.time_range.elapsed_us() for e in prof.events()
                            if e.device_type
                            == torch.autograd.DeviceType.CUDA) / 1e3
            idle = 1.0 - device_ms / (burst_wall * 1e3)
        else:
            burst = drive(port, tenants, clients, burst_n)
            burst_wall, device_ms, idle = burst["wall_s"], None, None
    finally:
        srv.stop()
        qe.concurrency.shutdown()
    left = set(threading.enumerate()) - before
    check(not left, f"{what}: threads outlived the server: "
          f"{sorted(t.name for t in left)}")
    errors = sum(run["errors"].values()) + sum(burst["errors"].values())
    check(errors == 0, f"{what}: {errors} failed requests, first "
          f"{run['first_error'] or burst['first_error']}")
    for sql, bs in burst["bodies"].items():
        run["bodies"].setdefault(sql, set()).update(bs)
    served = check_served(qe, run["bodies"], grid)
    n = run["requests"]
    tenants_out = {}
    for name, ls in run["lat"].items():
        a = np.asarray(ls) * 1e3
        tenants_out[name] = {
            "requests": len(ls), "errors": run["errors"][name],
            "p50_ms": float(np.percentile(a, 50)),
            "p99_ms": float(np.percentile(a, 99)),
            "p999_ms": float(np.percentile(a, 99.9))}
    cut = None
    if bench_total is not None and total != bench_total:
        cut = {"bench_requests": bench_total, "run_requests": total}
        log(f"serving {what}: requests cut from bench.py's {bench_total} "
            f"to {total}")
    out = {"requests": n, "requests_cut": cut,
           "clients": clients * len(tenants), "wall_s": run["wall_s"],
           "qps": n / run["wall_s"], "tenants": tenants_out,
           "batch_events": events, "lane": lane,
           "mean_vmap_width": wsum / wcount if wcount else None,
           "vmapped_groups": len(groups),
           "k2_calls_a_vmapped_group": sorted({c for _, c in groups}),
           "k1_launches": k1, "k2_launches": k2,
           "k1_per_request": k1 / n, "k2_per_request": k2 / n,
           "peak_device_bytes": peak,
           "profiled_burst": {"requests": burst["requests"],
                              "wall_s": burst_wall, "device_ms": device_ms,
                              "idle_share": idle},
           "checked": served, "phase_s": time.perf_counter() - t_phase,
           "groups": groups}
    log(f"serving {what}: " + json.dumps(
        {k: v for k, v in out.items() if k != "groups"}))
    check(all(c == 1 for _, c in groups),
          f"{what}: a vmapped group made K2 calls {sorted(set(groups))}")
    return out


def serving_cpu_phase(qe, sk, torch, grid) -> dict:
    """(a) bench.py's two serving configurations against the 17.28 M-row
    `cpu` table: identical single-groupby statements coalesce; the mixed
    traffic's dash siblings never stack (the table is over the batcher's
    4 Mi-row bound), as in the JAX package."""
    t = time.perf_counter()
    out = {
        "qps_single_groupby": serve_traffic(
            qe, sk, torch, "qps_single_groupby (cpu)",
            [("default", lambda i: single_groupby_sql())], QPS_CLIENTS,
            QPS_REQUESTS, grid)}
    # the index prunes the dash and ops statements' row groups
    region = qe.region_engine.region(
        qe.catalog.table("public", "cpu").region_ids[0])
    before = dict(region.prune_stats)
    out["qps_mixed_tenants"] = serve_traffic(
        qe, sk, torch, "qps_mixed_tenants (cpu)", mixed_tenants(HOURS),
        MIXED_CLIENTS, min(MIXED_REQUESTS_CPU, MIXED_REQUESTS), grid,
        bench_total=MIXED_REQUESTS)
    out["qps_mixed_tenants"]["pruning"] = pruned_since(region, before)
    log("serving qps_mixed_tenants (cpu): index pruning " + json.dumps(
        out["qps_mixed_tenants"]["pruning"]))
    from greptimedb_tpu_torch.concurrency import ConcurrencyConfig

    # where a served statement's host time goes: one warm serial run of
    # each tenant's statement under cProfile
    for name, gen in mixed_tenants(HOURS):
        with qe.concurrency.suppress_batching():
            log(f"serving host breakdown of a warm {name} statement: "
                + json.dumps(host_breakdown(lambda: qe.execute_one(gen(1)))))
    if HOSTS * HOURS * 3600 // STEP_S > ConcurrencyConfig().batch_max_rows:
        for name, r in out.items():
            check(r["batch_events"]["vmapped"] == 0,
                  f"{name} on cpu: a table past batch_max_rows stacked")
    check(out["qps_single_groupby"]["batch_events"]["coalesced"] > 0,
          "qps_single_groupby: no statement coalesced")
    # the same traffic with the JAX defaults: the plan cache and the fast
    # lane on, identical statements single-flight on the lane
    with defaults_plane(qe):
        out["qps_single_groupby_defaults"] = serve_traffic(
            qe, sk, torch, "qps_single_groupby (cpu, defaults)",
            [("default", lambda i: single_groupby_sql())], QPS_CLIENTS,
            QPS_REQUESTS, grid)
    lane = out["qps_single_groupby_defaults"]["lane"]
    check(lane["fast_lane"].get("hit", 0) > 0,
          f"qps_single_groupby with the defaults: no fast-lane hit {lane}")
    log(f"serving phase (a) on cpu: {time.perf_counter() - t:.1f} s")
    return out


def vmapped_batch_inputs(qe, sk, width) -> tuple:
    """The K2 call of a real dash batch: `width` members of the mixed
    traffic's dash statement (hosts 0..width-1, the same hour) through
    run_vmapped, the call's inputs captured. Returns (vals, ids, G,
    (min, max, sumsq))."""
    from greptimedb_tpu_torch.concurrency import batcher
    from greptimedb_tpu_torch.query import vmapped as vm
    from greptimedb_tpu_torch.session import QueryContext
    from greptimedb_tpu_torch.sql import parse_sql

    dash = mixed_tenants(SERVE_HOURS)[0][1]
    info = qe._table("cpu", QueryContext())
    sels = [parse_sql(dash(i))[0] for i in range(width)]
    shapes = [batcher.analyze(s, info) for s in sels]
    seen = []
    real = sk.fused_segment_agg

    def capture(vals, ids, g, *want, **kw):
        seen.append((vals, ids, g, tuple(want) or (
            kw.get("want_min", False), kw.get("want_max", False),
            kw.get("want_sumsq", False))))
        return real(vals, ids, g, *want, **kw)

    capture.launches = real.launches
    sk.fused_segment_agg = capture
    try:
        vm.run_vmapped(qe.executor, sels[0], info, shapes[0].params,
                       [s.values for s in shapes])
    finally:
        sk.fused_segment_agg = real
        real.launches = capture.launches
    check(len(seen) == 1, f"vmapped batch made {len(seen)} K2 calls")
    vals, ids, g, want = seen[0]
    check(g == width * 60 + 1 and vals.shape[1] == 1
          and want == (False, True, False),
          f"vmapped K2 shape {tuple(vals.shape)} G={g} want={want}")
    return vals, ids, g, want


def read_ready(proc, n: int, timeout: float = 180) -> list:
    """The first `n` lines a server prints, read off the raw pipe (a
    buffered reader could swallow several while select waits on the fd);
    "" for each line that did not come in time."""
    import select

    fd, buf = proc.stdout.fileno(), b""
    deadline = time.monotonic() + timeout
    while buf.count(b"\n") < n and time.monotonic() < deadline:
        ready, _, _ = select.select([fd], [], [], 1.0)
        if ready:
            chunk = os.read(fd, 4096)
            if not chunk:
                break
            buf += chunk
    return (buf.decode(errors="replace").splitlines(True) + [""] * n)[:n]


def standalone_phase(root, answers) -> dict:
    """(c) `python -m greptimedb_tpu_torch standalone start` on the card
    over the closed data dir: /health, the /v1/sql and query_range
    requests against the in-process answers, then SIGTERM and exit 0."""
    import signal
    import urllib.request

    cmd = [sys.executable, "-m", "greptimedb_tpu_torch", "standalone",
           "start", "--data-home", root, "--http-addr", "127.0.0.1:0"]
    if DEVICE is not None:
        cmd += ["--device", DEVICE]
    env = dict(os.environ, PYTHONPATH=HERE)
    t = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=HERE, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        line = read_ready(proc, 1)[0]
        check("listening on http://127.0.0.1:" in line,
              f"standalone did not start: {line!r} "
              f"{proc.stderr.read()[-2000:] if proc.poll() is not None else ''}")
        start_s = time.perf_counter() - t
        port = int(line.rsplit(":", 1)[1])
        base = f"http://127.0.0.1:{port}"
        with urllib.request.urlopen(base + "/health", timeout=60) as r:
            check(r.status == 200, "standalone /health")
        for path, data, want in answers:
            req = urllib.request.Request(base + path, data=data)
            with urllib.request.urlopen(req, timeout=120) as r:
                body = r.read()
            check(r.status == 200 and strip_time(body) == want,
                  f"standalone {path}: the body differs from the in-process "
                  "answer")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        check(rc == 0, f"standalone exited {rc}: {proc.stderr.read()[-2000:]}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out = {"start_s": start_s, "requests": len(answers) + 1, "exit_code": rc,
           "wall_s": time.perf_counter() - t}
    log("serving standalone subprocess: " + json.dumps(out))
    return out


def strip_time(body: bytes) -> bytes:
    i = body.rfind(b', "execution_time_ms"')
    return body if i < 0 else body[:i]


def in_process_answers(qe, requests) -> list:
    """[(path, body, response body without execution_time_ms)] from an
    in-process HttpServer on `qe`."""
    import urllib.request

    from greptimedb_tpu_torch.servers import HttpServer

    srv = HttpServer(qe, port=0)
    port = srv.start()
    out = []
    try:
        for path, data in requests:
            req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                         data=data)
            with urllib.request.urlopen(req, timeout=120) as r:
                check(r.status == 200, f"in-process {path}")
                out.append((path, data, strip_time(r.read())))
    finally:
        srv.stop()
        qe.concurrency.shutdown()
    return out


def serving_phase(sk, torch, lib=None) -> dict:
    """(b) the mixed traffic on a second data dir: bench.py's generator at
    HOSTS x SERVE_HOURS h at 10 s (1.44 M rows), flushed into one SST so
    each part is one device block; the dash siblings stack into vmapped
    groups, one K2 launch a group. Then K2 at a real batch's shape, and
    (c) the closed dir served by a standalone subprocess."""
    import shutil
    import tempfile
    import urllib.parse

    t = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    try:
        engine, qe = open_engine(root)
        qe.execute_one(cpu_ddl())
        info = qe.catalog.table("public", "cpu")
        points = SERVE_HOURS * 3600 // STEP_S
        host_names = np.asarray([f"host_{i}" for i in range(HOSTS)],
                                dtype=object)
        fields = {f: [] for f in FIELDS}
        rows = put_points(engine, info, np.random.default_rng(SERVE_SEED),
                          0, points, host_names, fields)
        qe.execute_one("ADMIN flush_table('cpu')")
        region = engine.region(info.region_ids[0])
        check(rows == HOSTS * points and len(region.files) == 1
              and region.memtable.num_rows == 0,
              f"serving dir: {rows} rows in {len(region.files)} SSTs")
        grid = {f: np.concatenate(fields[f]).reshape(points, HOSTS)
                for f in FIELDS}
        mixed = serve_traffic(qe, sk, torch, "qps_mixed_tenants (cpu_1h)",
                              mixed_tenants(SERVE_HOURS), MIXED_CLIENTS,
                              MIXED_REQUESTS, grid)
        ev = mixed["batch_events"]
        check(ev["vmapped"] > 0 and mixed["vmapped_groups"] > 0
              and mixed["k2_launches"] >= mixed["vmapped_groups"]
              and (mixed["mean_vmap_width"] or 0) > 1,
              f"cpu_1h: no vmapped batches ({ev}, width "
              f"{mixed['mean_vmap_width']})")
        # the same 3,000 requests with the JAX defaults: once a template
        # is learned its siblings are fast-lane hits, one serial K2 call
        # each, and no longer vmapped groups. The observability plane
        # runs as `standalone start` runs it: spans and the ledger, and
        # the flame sampler at 19 Hz (the server's stop joins it)
        from greptimedb_tpu_torch.utils import flame

        with defaults_plane(qe):
            flame.configure(enabled=True)
            mixed_defaults = serve_traffic(
                qe, sk, torch, "qps_mixed_tenants (cpu_1h, defaults)",
                mixed_tenants(SERVE_HOURS), MIXED_CLIENTS, MIXED_REQUESTS,
                grid)
        plane_ab = plane_ab_phase(qe, sk, torch, grid)
        lane = mixed_defaults["lane"]
        check(lane["fast_lane"].get("hit", 0) > 0,
              f"cpu_1h with the defaults: no fast-lane hit {lane}")
        # K2 at the shape a real dash batch of the mean width gives it,
        # against its plain version
        width = max(2, int(round(mixed["mean_vmap_width"])))
        vals, ids, g, want = vmapped_batch_inputs(qe, sk, width)
        case = None
        if lib is not None:
            case = k2_case(sk, lib, torch, vals, ids, g, want, "vmapped",
                           width)
            case.update(members=width, launches=mixed["vmapped_groups"])
        del vals, ids
        dash = mixed_tenants(SERVE_HOURS)[0][1]
        prom = urllib.parse.urlencode({
            "query": 'max_over_time(cpu{__field__="usage_user", '
                     'hostname="host_3"}[5m])',
            "start": str(T0_MS // 1000 + 300),
            "end": str(T0_MS // 1000 + 3300), "step": "60"})
        answers = in_process_answers(qe, [
            ("/v1/sql", urllib.parse.urlencode({"sql": dash(5)}).encode()),
            ("/v1/prometheus/api/v1/query_range?" + prom, None)])
        engine.close()
        cli = standalone_phase(root, answers)
        cli_options = standalone_options_phase(root, answers, grid,
                                               info.region_ids[0])
        fabric = fabric_phase(root, grid)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"serving phases (b), (c), (d), (i) on cpu_1h: "
        f"{time.perf_counter() - t:.1f} s")
    return {"mixed": mixed, "mixed_defaults": mixed_defaults,
            "plane_ab": plane_ab, "vmapped_case": case, "standalone": cli,
            "standalone_options": cli_options, "fabric": fabric}


#: requests a round of the observability plane's on/off comparison, and
#: the rounds: "on" = the defaults, "off" = no spans, ledger or sampler,
#: "spans" = spans and the ledger without the sampler. 400, cut from 800
#: to keep the script inside its time limit beside the metric and file
#: engines' phases (the run prints the count)
PLANE_AB_REQUESTS = 400
PLANE_AB_ROUNDS = ("off", "on", "spans", "off", "on", "spans")


def plane_ab_phase(qe, sk, torch, grid) -> dict:
    """The cost of the observability plane on the served mixed traffic
    (cpu_1h, the JAX defaults of the concurrency plane): rounds in turn
    with the plane at its defaults (spans, the ledger and the 19 Hz
    flame sampler), off (GTPU_TRACING=off, no sampler) and with spans
    and the ledger alone; the median qps and p99 of each arm and the
    device's idle share. The JAX package's budget is <= 2 %
    (greptimedb_tpu/options.py:366)."""
    from greptimedb_tpu_torch.utils import flame, tracing
    from greptimedb_tpu_torch.utils.metrics import ENCODE_SECONDS

    runs = {"on": [], "off": [], "spans": []}
    k1 = k2 = 0
    http_ms = []
    for arm in PLANE_AB_ROUNDS:
        e0 = (ENCODE_SECONDS.sum(protocol="http"),
              ENCODE_SECONDS.count(protocol="http"))
        with defaults_plane(qe), env_value(
                "GTPU_TRACING", "off" if arm == "off" else ""):
            if arm == "on":
                flame.configure(enabled=True)
            r = serve_traffic(
                qe, sk, torch, f"qps_mixed_tenants (cpu_1h, defaults, "
                f"observability {arm})", mixed_tenants(SERVE_HOURS),
                MIXED_CLIENTS, PLANE_AB_REQUESTS, grid)
        check(not flame.running(), "the flame sampler outlived its server")
        if arm == "on":
            # the request's HTTP layer from its spans: the request root
            # span's time outside its statement (body read and form
            # parse, the context, the disconnect watcher, the result's
            # JSON encode and send), and the encode alone
            spans = tracing.recent_spans(tracing._RING_CAP)
            stmt = {}
            for sp in spans:
                if sp.name.startswith("stmt:") and sp.parent_id:
                    stmt[sp.parent_id] = stmt.get(sp.parent_id, 0.0) \
                        + sp.duration_ms
            http_ms.extend(sp.duration_ms - stmt[sp.span_id]
                           for sp in spans if sp.name == "http:/v1/sql"
                           and sp.span_id in stmt)
            n_enc = ENCODE_SECONDS.count(protocol="http") - e0[1]
            enc_ms = (ENCODE_SECONDS.sum(protocol="http") - e0[0]) \
                / max(n_enc, 1) * 1e3
        k1 += r["k1_launches"]
        k2 += r["k2_launches"]
        runs[arm].append({"qps": r["qps"], "p99_ms_max_tenant": max(
                          v["p99_ms"] for v in r["tenants"].values()),
                          "p50_ms": {t: v["p50_ms"]
                                     for t, v in r["tenants"].items()},
                          "p99_ms": {t: v["p99_ms"]
                                     for t, v in r["tenants"].items()},
                          "idle_share": r["profiled_burst"]["idle_share"]})
        if arm == "on":
            runs[arm][-1]["encode_ms_mean"] = enc_ms
    med = {arm: float(np.median([x["qps"] for x in rs]))
           for arm, rs in runs.items()}
    check(len(http_ms) > 0, "no http:/v1/sql span with its statement")
    h = np.asarray(http_ms)
    out = {"rounds": list(PLANE_AB_ROUNDS), "requests": PLANE_AB_REQUESTS,
           "runs": runs, "median_qps": med,
           "http_outside_statement_ms": {
               "spans": len(h), "p50": float(np.percentile(h, 50)),
               "p99": float(np.percentile(h, 99)),
               "mean": float(h.mean())},
           "qps_cost": 1.0 - med["on"] / med["off"],
           "qps_cost_spans_alone": 1.0 - med["spans"] / med["off"],
           "k1_launches": k1, "k2_launches": k2}
    log("observability plane on/off, cpu_1h mixed traffic: " + json.dumps(
        {k: v for k, v in out.items() if k != "runs"}) + " runs "
        + json.dumps(runs))
    return out


# ---- the front door: plan cache, fast lane, wire servers, options -----------

#: how the phases before the front door's run: every statement parsed and
#: planned (as before the port had either cache), as the JAX package with
#: these set
LANE_OFF = {"GTPU_FAST_LANE": "0", "GTPU_PLAN_CACHE_ENTRIES": "0"}
LANE_STAGES = ("parse", "plan", "execute", "fast_bind", "fast_execute")
#: the wire phase's concurrent MySQL traffic: connections x requests
WIRE_CLIENTS = 20
WIRE_REQUESTS = 50
#: hosts the prepared dash statement rotates over
PREPARED_HOSTS = 50
STATIC_USER = ("chip", "smoke")


class defaults_plane:
    """`qe` serves through a fresh concurrency plane with the JAX
    defaults (plan cache 512 shapes, fast lane on) inside the block; the
    plane is shut down and the engine's own restored after it."""

    def __init__(self, qe):
        self.qe = qe

    def __enter__(self):
        from greptimedb_tpu_torch.concurrency import (
            ConcurrencyConfig,
            ConcurrencyPlane,
        )

        self.saved = self.qe.concurrency
        self.qe.concurrency = ConcurrencyPlane(ConcurrencyConfig())
        return self.qe.concurrency

    def __exit__(self, *exc):
        self.qe.concurrency.shutdown()
        self.qe.concurrency = self.saved


def lane_snapshot() -> dict:
    """The plan cache's and the fast lane's events (fallbacks and skips
    by reason) and the serving stages' seconds and counts."""
    from greptimedb_tpu_torch.utils import metrics as m

    def by_kind(counter):
        out: dict = {}
        for key, v in counter._snapshot().items():
            d = dict(key)
            name = d["event"] + (f":{d['reason']}" if "reason" in d else "")
            out[name] = out.get(name, 0) + v
        return out

    return {"fast_lane": by_kind(m.FAST_LANE_EVENTS),
            "plan_cache": by_kind(m.PLAN_CACHE_EVENTS),
            "stages": {st: (m.STAGE_SECONDS.total_sum(stage=st),
                            m.STAGE_SECONDS.total_count(stage=st))
                       for st in LANE_STAGES}}


def lane_report(before, requests: int) -> dict:
    """What moved since `before`: events by kind, bench.py's hit rates
    (plan cache hit / (hit + miss); fast lane hit / (hit + miss +
    fallbacks)) and each stage's seconds, count and ms a request."""
    now = lane_snapshot()
    out = {}
    for part in ("fast_lane", "plan_cache"):
        out[part] = {k: int(v - before[part].get(k, 0))
                     for k, v in now[part].items()
                     if v != before[part].get(k, 0)}
    pc, fl = out["plan_cache"], out["fast_lane"]
    hm = pc.get("hit", 0) + pc.get("miss", 0)
    pc["hit_rate"] = pc.get("hit", 0) / hm if hm else None
    asked = fl.get("hit", 0) + fl.get("miss", 0) + sum(
        v for k, v in fl.items() if k.startswith("fallback"))
    fl["hit_rate"] = fl.get("hit", 0) / asked if asked else None
    out["stages"] = {}
    for st in LANE_STAGES:
        secs = now["stages"][st][0] - before["stages"][st][0]
        n = now["stages"][st][1] - before["stages"][st][1]
        if n:
            out["stages"][st] = {"s": secs, "n": n,
                                 "ms_a_request": secs * 1e3 / max(1, requests)}
    return out


class WireError(Exception):
    pass


class WireMysql:
    """A stdlib MySQL client: the v10 handshake (mysql_native_password
    when a password is given), COM_QUERY with text rows, and
    COM_STMT_PREPARE / EXECUTE with string or integer parameters and
    binary rows."""

    def __init__(self, port, user="chip", password=None):
        import hashlib
        import socket
        import struct

        self.struct = struct
        self.sock = socket.create_connection(("127.0.0.1", port),
                                             timeout=300)
        self.seq = 0
        hello = self._packet()
        pos = hello.index(b"\x00", 1) + 1 + 4
        salt = hello[pos:pos + 8]
        salt += hello[pos + 8 + 1 + 2 + 1 + 2 + 2 + 1 + 10:][:12]
        auth = b""
        if password:
            h1 = hashlib.sha1(password.encode()).digest()
            h3 = hashlib.sha1(salt + hashlib.sha1(h1).digest()).digest()
            auth = bytes(a ^ b for a, b in zip(h1, h3))
        self._send(struct.pack("<II", 0x0200 | 0x8000, 1 << 24)
                   + bytes([0x21]) + b"\x00" * 23 + user.encode() + b"\x00"
                   + bytes([len(auth)]) + auth)
        self._check(self._packet())

    def _read(self, n):
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise WireError("mysql connection closed")
            buf += chunk
        return buf

    def _packet(self):
        h = self._read(4)
        self.seq = (h[3] + 1) & 0xFF
        return self._read(h[0] | (h[1] << 8) | (h[2] << 16))

    def _send(self, payload):
        self.sock.sendall(self.struct.pack("<I", len(payload))[:3]
                          + bytes([self.seq]) + payload)
        self.seq = (self.seq + 1) & 0xFF

    def _check(self, pkt):
        if pkt[0] == 0xFF:
            code = self.struct.unpack("<H", pkt[1:3])[0]
            raise WireError(f"mysql error {code}: {pkt[9:].decode()}")
        return pkt

    @staticmethod
    def _lenc(pkt, pos):
        n = pkt[pos]
        if n == 0xFC:
            return int.from_bytes(pkt[pos + 1:pos + 3], "little"), pos + 3
        if n == 0xFD:
            return int.from_bytes(pkt[pos + 1:pos + 4], "little"), pos + 4
        return n, pos + 1

    def _columns(self, ncols):
        names = []
        for _ in range(ncols):
            pkt, pos = self._packet(), 0
            for _ in range(4):
                n, pos = self._lenc(pkt, pos)
                pos += n
            n, pos = self._lenc(pkt, pos)
            names.append(pkt[pos:pos + n].decode())
        self._packet()  # EOF
        return names

    def query(self, sql):
        self.seq = 0
        self._send(b"\x03" + sql.encode())
        first = self._check(self._packet())
        if first[0] == 0x00:
            return ("ok", self._lenc(first, 1)[0])
        names, rows = self._columns(first[0]), []
        while True:
            pkt = self._packet()
            if pkt[0] == 0xFE and len(pkt) < 9:
                return ("rows", names, rows)
            row, pos = [], 0
            while pos < len(pkt):
                if pkt[pos] == 0xFB:
                    row.append(None)
                    pos += 1
                    continue
                n, pos = self._lenc(pkt, pos)
                row.append(pkt[pos:pos + n].decode())
                pos += n
            rows.append(row)

    def prepare(self, sql):
        self.seq = 0
        self._send(b"\x16" + sql.encode())
        first = self._check(self._packet())
        stmt, ncols, nparams = self.struct.unpack("<IHH", first[1:9])
        for _ in range(nparams + (1 if nparams else 0)):
            self._packet()
        for _ in range(ncols + (1 if ncols else 0)):
            self._packet()
        return stmt

    def execute(self, stmt, params):
        st = self.struct
        types, values = b"", b""
        for p in params:
            if isinstance(p, int):
                types += bytes([8, 0])
                values += st.pack("<q", p)
            else:
                raw = str(p).encode()
                types += bytes([253, 0])
                values += bytes([len(raw)]) + raw
        self.seq = 0
        self._send(b"\x17" + st.pack("<IBI", stmt, 0, 1)
                   + bytes((len(params) + 7) // 8) + b"\x01" + types
                   + values)
        first = self._check(self._packet())
        names, rows = self._columns(first[0]), []
        nb = (len(names) + 9) // 8
        while True:
            pkt = self._packet()
            if pkt[0] == 0xFE and len(pkt) < 9:
                return ("rows", names, rows)
            pos, row = 1 + nb, []
            for i in range(len(names)):
                if pkt[1 + (i + 2) // 8] & (1 << ((i + 2) % 8)):
                    row.append(None)
                    continue
                n, pos = self._lenc(pkt, pos)
                row.append(pkt[pos:pos + n].decode())
                pos += n
            rows.append(row)

    def close(self):
        self.seq = 0
        self._send(b"\x01")
        self.sock.close()


class WirePg:
    """A stdlib PostgreSQL client: the startup message (a cleartext
    password when asked) and the simple query protocol."""

    def __init__(self, port, user="chip", password=None):
        import socket
        import struct

        self.struct = struct
        self.sock = socket.create_connection(("127.0.0.1", port),
                                             timeout=300)
        body = struct.pack("!I", 196608) + b"user\x00" + user.encode() \
            + b"\x00database\x00public\x00\x00"
        self.sock.sendall(struct.pack("!I", len(body) + 4) + body)
        while True:
            t, body = self._msg()
            if t == b"R" and struct.unpack("!I", body[:4])[0] == 3:
                pw = (password or "").encode() + b"\x00"
                self.sock.sendall(b"p" + struct.pack("!I", len(pw) + 4) + pw)
            elif t == b"E":
                raise WireError(f"pg error: {body!r}")
            elif t == b"Z":
                return

    def _read(self, n):
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise WireError("postgres connection closed")
            buf += chunk
        return buf

    def _msg(self):
        t = self._read(1)
        n = self.struct.unpack("!I", self._read(4))[0]
        return t, self._read(n - 4) if n > 4 else b""

    def query(self, sql):
        st = self.struct
        body = sql.encode() + b"\x00"
        self.sock.sendall(b"Q" + st.pack("!I", len(body) + 4) + body)
        cols, rows, tag, err = [], [], None, None
        while True:
            t, body = self._msg()
            if t == b"T":
                pos = 2
                for _ in range(st.unpack("!h", body[:2])[0]):
                    end = body.index(b"\x00", pos)
                    cols.append(body[pos:end].decode())
                    pos = end + 19
            elif t == b"D":
                pos, row = 2, []
                for _ in range(st.unpack("!h", body[:2])[0]):
                    n = st.unpack("!i", body[pos:pos + 4])[0]
                    pos += 4
                    row.append(None if n < 0
                               else body[pos:pos + n].decode())
                    pos += max(n, 0)
                rows.append(row)
            elif t == b"C":
                tag = body.rstrip(b"\x00").decode()
            elif t == b"E":
                err = body
            elif t == b"Z":
                if err is not None:
                    raise WireError(f"pg error: {err!r}")
                return cols, rows, tag

    def close(self):
        self.sock.sendall(b"X" + self.struct.pack("!I", 4))
        self.sock.close()


def wire_text(res) -> list:
    """The in-process result as both wires' text rows: floats as their
    repr, NULL (None or NaN) as None, everything else as str."""
    out = []
    for row in res.rows():
        out.append([None if v is None or (isinstance(v, float) and v != v)
                    else repr(float(v)) if isinstance(v, float)
                    else str(v) for v in row])
    return out


def wire_rows_match(names, got, want) -> bool:
    """Text rows of a wire against the in-process result's: exact, but
    averages to rtol 1e-5 — a rerun's f32 sums on the card add in
    another order (atomics), as check_served holds served bodies."""
    if len(got) != len(want):
        return False
    for g, w in zip(got, want):
        for name, a, b in zip(names, g, w):
            if name.startswith("avg(") and a is not None and b is not None:
                if abs(float(a) - float(b)) > 1e-5 * abs(float(b)):
                    return False
            elif a != b:
                return False
    return True


def wire_phase(qe, sk, torch, grid) -> dict:
    """(c) in-process MysqlServer and PostgresServer over the 17.28 M-row
    `cpu` table, the engine on a plane with the JAX defaults: bench.py's
    four dashboard queries over both wires, each equal to the in-process
    result and that to numpy (double_groupby_all's MySQL run counted:
    K1); a prepared dash statement executed for PREPARED_HOSTS hosts
    (binary rows against numpy; the template's later hosts must be
    fast-lane hits); then WIRE_CLIENTS MySQL connections x WIRE_REQUESTS
    single-groupby statements for qps and latency, every response equal
    to the in-process one. No server thread may outlive shutdown()."""
    import threading

    from greptimedb_tpu_torch.servers.mysql import MysqlServer
    from greptimedb_tpu_torch.servers.postgres import PostgresServer

    t_phase = time.perf_counter()
    before_threads = set(threading.enumerate())
    queries = tsbs_queries()
    out = {"queries": {}}
    with defaults_plane(qe):
        ms, ps = MysqlServer(qe, port=0), PostgresServer(qe, port=0)
        ms.start()
        ps.start()
        try:
            my, pg = WireMysql(ms.port), WirePg(ps.port)
            zero_launches(sk)
            wire_k = np.zeros(2, dtype=np.int64)  # K1, K2 of wire requests
            for name in ("single_groupby_1_1_1", "cpu_max_all_8",
                         "groupby_orderby_limit", "double_groupby_all"):
                sql = queries[name][0]
                # the classic routes, as the main path: cached partials
                # of the earlier phases would serve these without a launch.
                # The in-process run first: it warms the hot set, so both
                # wires are timed warm
                with partial_cache(False):
                    t = time.perf_counter()
                    res = qe.execute_one(sql)
                    local_ms = (time.perf_counter() - t) * 1e3
                    k0 = launches(sk)
                    t = time.perf_counter()
                    got_my = my.query(sql)
                    my_ms = (time.perf_counter() - t) * 1e3
                    k1 = launches(sk)
                    t = time.perf_counter()
                    got_pg = pg.query(sql)
                    pg_ms = (time.perf_counter() - t) * 1e3
                    wire_k += np.subtract(launches(sk), k0)
                check_result(name, res, grid)
                want, names = wire_text(res), list(res.names)
                check(got_my[:2] == ("rows", names)
                      and wire_rows_match(names, got_my[2], want),
                      f"wire {name}: the MySQL rows differ from the "
                      "in-process result")
                check(got_pg[0] == names and got_pg[2] == f"SELECT {len(want)}"
                      and wire_rows_match(names, got_pg[1], want),
                      f"wire {name}: the Postgres rows differ from the "
                      "in-process result")
                out["queries"][name] = {
                    "rows": len(want), "in_process_ms": local_ms,
                    "mysql_ms": my_ms, "postgres_ms": pg_ms,
                    "mysql_k1": k1[0] - k0[0], "mysql_k2": k1[1] - k0[1]}
            q = out["queries"]
            check(q["double_groupby_all"]["mysql_k1"] >= 1,
                  "wire double_groupby_all over MySQL launched no K1")
            check(q["single_groupby_1_1_1"]["mysql_k2"] >= 1
                  and q["cpu_max_all_8"]["mysql_k2"] >= 1,
                  "wire dash statements over MySQL launched no K2")
            # a prepared dash statement rotated over the hosts
            lane0 = lane_snapshot()
            stmt = my.prepare(
                "SELECT date_bin(INTERVAL '1 minute', ts) AS minute, "
                "max(usage_user) FROM cpu WHERE hostname = ? AND ts >= ? "
                "AND ts < ? GROUP BY minute")
            k0 = launches(sk)
            t = time.perf_counter()
            for h in range(PREPARED_HOSTS):
                kind, names, rows = my.execute(
                    stmt, [f"host_{h}", T0_MS, T0_MS + 3600 * 1000])
                want = grid["usage_user"][:3600 // STEP_S, h].reshape(
                    60, -1).max(axis=1)
                check(names == ["minute", "max(usage_user)"]
                      and [int(r[0]) for r in rows]
                      == [T0_MS + i * 60_000 for i in range(60)]
                      and np.array_equal(
                          np.asarray([float(r[1]) for r in rows]),
                          f32_exact(want)),
                      f"wire prepared dash statement, host_{h}")
            prepared_s = time.perf_counter() - t
            wire_k += np.subtract(launches(sk), k0)
            lane = lane_report(lane0, PREPARED_HOSTS)
            out["prepared"] = {"executes": PREPARED_HOSTS,
                               "ms_an_execute": prepared_s * 1e3
                               / PREPARED_HOSTS, "lane": lane}
            check(lane["fast_lane"].get("hit", 0)
                  + lane["plan_cache"].get("hit", 0) > 0,
                  f"the prepared dash statement made no cache hit: {lane}")
            my.close()
            pg.close()
            # WIRE_CLIENTS connections x WIRE_REQUESTS statements
            sql = single_groupby_sql()
            want = ("rows", ["minute", "max(usage_user)"],
                    wire_text(qe.execute_one(sql)))
            lat, errors, lock = [], [], threading.Lock()
            lane0 = lane_snapshot()
            k0 = launches(sk)

            def client():
                mine = []
                try:
                    c = WireMysql(ms.port)
                    for _ in range(WIRE_REQUESTS):
                        t = time.perf_counter()
                        got = c.query(sql)
                        mine.append(time.perf_counter() - t)
                        if got != want:
                            raise WireError("a response differs from the "
                                            "in-process result")
                    c.close()
                except Exception as e:  # noqa: BLE001 — counted below
                    with lock:
                        errors.append(repr(e))
                with lock:
                    lat.extend(mine)

            threads = [threading.Thread(target=client)
                       for _ in range(WIRE_CLIENTS)]
            t = time.perf_counter()
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            wall = time.perf_counter() - t
            k1, k2 = np.subtract(launches(sk), k0)
            wire_k += (k1, k2)
            check(not errors, f"wire traffic: {len(errors)} failed "
                  f"clients, first {errors[:1]}")
            a = np.asarray(lat) * 1e3
            out["traffic"] = {
                "connections": WIRE_CLIENTS, "requests": len(lat),
                "wall_s": wall, "qps": len(lat) / wall,
                "p50_ms": float(np.percentile(a, 50)),
                "p99_ms": float(np.percentile(a, 99)),
                "k1_launches": int(k1), "k2_launches": int(k2),
                "lane": lane_report(lane0, len(lat))}
        finally:
            ms.shutdown()
            ps.shutdown()
    left = set(threading.enumerate()) - before_threads
    check(not left, f"wire: threads outlived shutdown(): "
          f"{sorted(t.name for t in left)}")
    # launches of the wire requests only (not of the in-process runs
    # they are compared with)
    out.update(k1_launches=int(wire_k[0]), k2_launches=int(wire_k[1]),
               phase_s=time.perf_counter() - t_phase)
    log("wire (cpu): " + json.dumps(out))
    return out


# ---- (e) the write protocols -------------------------------------------------

#: lines a line-protocol request (bench.py:1313) and the HTTP clients
LP_BODY_LINES = 5000
LP_CLIENTS = 8
#: hours of `cpu` written again through the line protocol (TSBS's first)
LP_HOURS = 1
#: bench.py's ingest_qps traffic (bench.py:1282-1460)
INGESTQ_SECONDS = 12.0
INGESTQ_SQL_ROWS = 500
INGESTQ_SQL_PACE_S = 0.1
INGESTQ_HOSTS = 200
INGESTQ_FIELDS = [f"f{i}" for i in range(5)]
#: Prometheus remote write: queue_config.max_samples_per_send's default
RW_SAMPLES_PER_SEND = 2000
RW_CLIENTS = 4
#: the phase's time budget on the card, and what part 4 leaves for the
#: reads and part 5 when it sizes its writes
WRITE_PHASE_BUDGET_S = 120.0
RW_RESERVE_S = 25.0


class lane_counter:
    """Counts, for the block, the line-protocol bodies the vector lane
    (influx._vector_parse) took and those it left to the Python lanes;
    write_lines looks the lane up in its module at call time."""

    def __enter__(self):
        import threading

        from greptimedb_tpu_torch.servers import influx

        self.mod, self.saved = influx, influx._vector_parse
        self.counts = {"vector": 0, "python": 0}
        lock = threading.Lock()

        def counted(*args, **kw):
            got = self.saved(*args, **kw)
            with lock:
                self.counts["vector" if got is not None else "python"] += 1
            return got

        influx._vector_parse = counted
        return self.counts

    def __exit__(self, *exc):
        self.mod._vector_parse = self.saved
        return False


def post_all(port, path, bodies, clients, headers) -> dict:
    """`bodies` over `clients` keep-alive connections (body i on client
    i % clients, in order): each answer's status and latency, the wall
    time and the first failure."""
    import http.client
    import threading

    status = [None] * len(bodies)
    lat = [0.0] * len(bodies)
    first_error: list = []

    def client(c):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        try:
            for i in range(c, len(bodies), clients):
                t0 = time.perf_counter()
                try:
                    conn.request("POST", path, body=bodies[i],
                                 headers=headers)
                    resp = conn.getresponse()
                    data = resp.read()
                except Exception as e:  # noqa: BLE001 — counted, reported
                    first_error.append(repr(e))
                    conn.close()
                    continue
                lat[i] = time.perf_counter() - t0
                status[i] = resp.status
                if resp.status >= 300:
                    first_error.append(data[:300].decode(errors="replace"))
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    t = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    wall = time.perf_counter() - t
    a = np.asarray(lat) * 1e3
    return {"status": status, "wall_s": wall,
            "p50_ms": float(np.percentile(a, 50)),
            "p99_ms": float(np.percentile(a, 99)),
            "first_error": first_error[:1]}


def cpu_lp_bodies(grid, host_names, hosts: int = 0) -> list:
    """The first LP_HOURS of `cpu` as line protocol (measurement cpu_lp,
    ms timestamps, each value printed with repr so that it parses back
    to the same float64), in bodies of LP_BODY_LINES lines, time-major
    like TSBS's generator; the first `hosts` hosts (0: all HOSTS)."""
    nh = hosts or HOSTS
    points = LP_HOURS * 3600 // STEP_S
    fmt = "cpu_lp,hostname={} " + ",".join(f"{f}={{}}" for f in FIELDS) \
        + " {}"
    cols = [grid[f][:points, :nh].reshape(-1) for f in FIELDS]
    hosts = np.tile(np.asarray(host_names[:nh], dtype=object), points)
    ts = np.repeat(T0_MS + np.arange(points, dtype=np.int64)
                   * STEP_S * 1000, nh)
    bodies = []
    for lo in range(0, points * nh, LP_BODY_LINES):
        hi = min(lo + LP_BODY_LINES, points * nh)
        bodies.append("\n".join(map(
            fmt.format, hosts[lo:hi].tolist(),
            *(map(repr, c[lo:hi].tolist()) for c in cols),
            ts[lo:hi].tolist())).encode())
    return bodies


def cpu_lp_phase(qe, sk, torch, grid, host_names, port) -> dict:
    """Part 1: TSBS's first hour over the line protocol through the HTTP
    server; part 2: bench.py's six queries over what it wrote."""
    from greptimedb_tpu_torch.session import QueryContext

    t = time.perf_counter()
    bodies = cpu_lp_bodies(grid, host_names)
    build_s = time.perf_counter() - t
    rows = LP_HOURS * 3600 // STEP_S * HOSTS
    nbytes = sum(len(b) for b in bodies)
    with lane_counter() as lanes:
        sent = post_all(port, "/v1/influxdb/write?precision=ms", bodies,
                        LP_CLIENTS, {"Content-Type": "text/plain"})
    check(sent["status"] == [204] * len(bodies),
          f"cpu_lp: not every body got 204 ({sent['first_error']})")
    wall = sent["wall_s"]
    count = qe.execute_one("SELECT count(*) FROM cpu_lp").rows()[0][0]
    check(count == rows, f"cpu_lp: count(*) {count}, expected {rows}")
    info = qe._table("cpu_lp", QueryContext(db="public"))
    check(not info.options.get("append_mode")
          and info.schema.names == ["hostname", "ts"] + FIELDS,
          f"cpu_lp: auto-created as {info.schema.names} {info.options}")
    ingest = {"rows": rows, "bodies": len(bodies),
              "lines_a_body": LP_BODY_LINES, "clients": LP_CLIENTS,
              "body_bytes": nbytes, "build_s": build_s, "wall_s": wall,
              "rows_per_s": rows / wall, "mb_per_s": nbytes / wall / 1e6,
              "ack_p50_ms": sent["p50_ms"], "ack_p99_ms": sent["p99_ms"],
              "lanes": dict(lanes)}
    log("write protocols: cpu_lp ingest over HTTP: " + json.dumps(ingest))
    check(lanes["vector"] == len(bodies),
          f"cpu_lp: the vector lane took {lanes['vector']} of "
          f"{len(bodies)} bodies")

    # part 2: the queries, the partial cache off (the classic routes, so
    # each cold run launches its kernel)
    grid1 = {f: grid[f][:LP_HOURS * 3600 // STEP_S] for f in FIELDS}
    cpu_routes = tsbs_queries()
    queries = dict(tsbs_queries("cpu_lp"))
    # double_groupby_all over the hour alone: 4,000 groups, within K2's
    # segment budget (MAX_SEGMENTS), so the fused route
    queries["double_groupby_all (hour range)"] = (
        queries["double_groupby_all"][0].replace(
            f"ts < {T0_MS + HOURS * 3600 * 1000}",
            f"ts < {T0_MS + LP_HOURS * 3600 * 1000}"), None, None)
    out = {"ingest": ingest, "queries": {}}
    launched = np.zeros(2, dtype=np.int64)
    with partial_cache(False):
        region = qe.region_engine.region(info.region_ids[0])
        scan = region.scan()
        dedup_ms = []
        for _ in range(4):
            sync(torch)
            t = time.perf_counter()
            qe.executor._compute_dedup(scan, info)
            sync(torch)
            dedup_ms.append((time.perf_counter() - t) * 1e3)
        out["dedup"] = {"rows": scan.num_rows, "cold_ms": dedup_ms[0],
                        "warm_p50_ms": float(np.median(dedup_ms[1:]))}
        log("write protocols: cpu_lp sort-dedup of the memtable scan: "
            + json.dumps(out["dedup"]))
        for name, (sql, _, _) in queries.items():
            base = name.split(" (")[0]
            k0 = launches(sk)
            res, cold_ms = timed_query(qe, sql, torch)
            k = np.subtract(launches(sk), k0)
            launched += k
            path = qe.executor.last_path if base != "high_cpu_all" else None
            warm = [timed_query(qe, sql, torch)[1] for _ in range(3)]
            check_result(base, res, grid1, hours=LP_HOURS)
            want_path = cpu_routes[base][1] if name == base else \
                "dense_fused"
            want_k = (int(want_path == "dense_prepared"),
                      int(want_path is not None
                          and want_path.endswith("dense_fused")))
            rec = {"rows": res.num_rows, "last_path": path,
                   "route_over_cpu": want_path, "cold_ms": cold_ms,
                   "warm_p50_ms": float(np.median(warm)),
                   "k1_launches": int(k[0]), "k2_launches": int(k[1])}
            out["queries"][name] = rec
            log(f"write protocols: cpu_lp query {name}: " + json.dumps(rec))
            check((rec["k1_launches"] > 0, rec["k2_launches"] > 0)
                  == (bool(want_k[0]), bool(want_k[1])),
                  f"cpu_lp {name}: launched K1 {rec['k1_launches']}, K2 "
                  f"{rec['k2_launches']}; the route over cpu is {want_path}")
    out["k1_launches"], out["k2_launches"] = (int(x) for x in launched)
    return out


def ingestq_template(w: int, rng, table: str = "ingestq") -> str:
    """bench.py's ingest_qps body (ingestq, 5 fields, 200 hosts, 5,000
    lines) with its timestamps as an 8-digit request slot and a 4-digit
    line number: `.replace(" 99999999", f" {slot:08d}")` makes a body
    whose keys no other request repeats."""
    vals = rng.uniform(0.0, 100.0, (LP_BODY_LINES, len(INGESTQ_FIELDS)))
    hosts = rng.integers(0, INGESTQ_HOSTS, LP_BODY_LINES)
    return "\n".join(
        f"{table},hostname=host_{int(h)} "
        + ",".join(f"{f}={v:.3f}" for f, v in zip(INGESTQ_FIELDS, row))
        + f" 99999999{j:04d}"
        for j, (h, row) in enumerate(zip(hosts, vals)))


def write_plane_counters(engine) -> dict:
    """The write plane's counters, to difference around a run: WAL
    fsyncs, group-commit events, rows a commit (the batch histogram's sum
    and count), maintenance jobs and stalled seconds."""
    from greptimedb_tpu_torch.utils.metrics import (
        INGEST_BATCH_SIZE,
        INGEST_GROUP_COMMIT_EVENTS,
        MAINTENANCE_JOBS,
        WRITE_STALL_SECONDS,
    )

    out = {"wal_fsyncs": engine.wal.sync_count,
           "commit_rows": INGEST_BATCH_SIZE.total_sum(),
           "commits": INGEST_BATCH_SIZE.total_count(),
           "maintenance_jobs": MAINTENANCE_JOBS.total(),
           "stall_s": WRITE_STALL_SECONDS.total()}
    for ev in ("lead", "follow", "overflow", "deadline"):
        out[ev] = INGEST_GROUP_COMMIT_EVENTS.total(event=ev)
    return out


def ingest_qps_phase(qe, sk, torch, table: str = "ingestq") -> dict:
    """bench.py's ingest_qps in process: line-protocol writers
    (bench.py's writer count for this machine, less the SQL writer) of
    5,000-line bodies into `table`, one SQL INSERT writer of 500 rows
    paced at 0.1 s, two readers of the warm `cpu` per-minute max query,
    for INGESTQ_SECONDS. Every request writes keys no other writes, so
    count(*) must equal the rows acknowledged. The engine's write plane
    decides how writes commit (group commit, write workers, the
    maintenance plane's async flushes): its counters are printed."""
    import threading

    from greptimedb_tpu_torch.servers.influx import write_lines

    rng = np.random.default_rng(23)
    writers = max(5, min(12, 2 * (os.cpu_count() or 4) + 1))
    lp_writers = writers - 1
    templates = [ingestq_template(w, rng, table) for w in range(lp_writers)]
    n_sql = int(INGESTQ_SECONDS / INGESTQ_SQL_PACE_S) + 10
    sql_pool = []
    for i in range(n_sql):
        t0 = 500_000_000 + i * INGESTQ_SQL_ROWS
        vals = rng.uniform(0.0, 100.0, (INGESTQ_SQL_ROWS,
                                         len(INGESTQ_FIELDS)))
        hosts = rng.integers(0, INGESTQ_HOSTS, INGESTQ_SQL_ROWS)
        sql_pool.append(
            f"INSERT INTO {table} (hostname, ts, "
            f"{', '.join(INGESTQ_FIELDS)}) VALUES " + ", ".join(
                f"('host_{int(h)}', {t0 + j}, "
                + ", ".join(f"{v:.3f}" for v in row) + ")"
                for j, (h, row) in enumerate(zip(hosts, vals))))
    # the table is created (auto-create, not append mode) outside the clock
    write_lines(qe, "public", templates[0].replace(" 99999999",
                                                   " 00000000"), "ms")
    read_sql = (
        f"SELECT date_bin(INTERVAL '1 minute', ts) AS minute, "
        f"max(usage_user) FROM cpu WHERE hostname = 'host_1' "
        f"AND ts >= {T0_MS} AND ts < {T0_MS + 3600 * 1000} GROUP BY minute")
    qe.execute_one(read_sql)  # warm
    idle = [timed_query(qe, read_sql, torch)[1] for _ in range(20)]
    stop = threading.Event()
    rows_done = [0] * writers
    lp_lat: list = [[] for _ in range(lp_writers)]
    sql_lat: list = []
    read_lat: list = [[] for _ in range(2)]
    errors: list = []

    def lp_writer(w):
        i = 0
        while not stop.is_set():
            body = templates[w].replace(
                " 99999999", f" {1 + w * 100_000 + i:08d}")
            t0 = time.perf_counter()
            try:
                write_lines(qe, "public", body, precision="ms")
            except Exception as e:  # noqa: BLE001 — counted, none allowed
                errors.append(repr(e))
                return
            lp_lat[w].append(time.perf_counter() - t0)
            rows_done[w] += LP_BODY_LINES
            i += 1

    def sql_writer():
        for stmt in sql_pool:
            if stop.is_set():
                return
            t0 = time.perf_counter()
            try:
                qe.execute_one(stmt)
            except Exception as e:  # noqa: BLE001 — counted, none allowed
                errors.append(repr(e))
                return
            sql_lat.append(time.perf_counter() - t0)
            rows_done[-1] += INGESTQ_SQL_ROWS
            time.sleep(INGESTQ_SQL_PACE_S)
        errors.append("the SQL writer ran out of statements")

    def reader(r):
        while not stop.is_set():
            t0 = time.perf_counter()
            try:
                res = qe.execute_one(read_sql)
            except Exception as e:  # noqa: BLE001 — counted, none allowed
                errors.append(repr(e))
                return
            read_lat[r].append(time.perf_counter() - t0)
            if res.num_rows != 60:
                errors.append(f"a read returned {res.num_rows} rows, "
                              "not 60")
                return

    threads = ([threading.Thread(target=lp_writer, args=(w,))
                for w in range(lp_writers)]
               + [threading.Thread(target=sql_writer)]
               + [threading.Thread(target=reader, args=(r,))
                  for r in range(2)])
    plane0 = write_plane_counters(qe.region_engine)
    k0 = launches(sk)
    t_start = time.perf_counter()
    for th in threads:
        th.start()
    time.sleep(INGESTQ_SECONDS)
    stop.set()
    for th in threads:
        th.join()
    wall = time.perf_counter() - t_start
    k = np.subtract(launches(sk), k0)
    reads = sum(len(r) for r in read_lat)
    acked = sum(rows_done)
    plane = {k: v - plane0[k] for k, v in
             write_plane_counters(qe.region_engine).items()}
    count = qe.execute_one(f"SELECT count(*) FROM {table}").rows()[0][0]
    lp_all = np.asarray([x for ls in lp_lat for x in ls]) * 1e3
    reads_ms = np.asarray([x for ls in read_lat for x in ls]) * 1e3
    out = {"rows_per_s": acked / wall, "wall_s": wall,
           "writers": {"line_protocol": lp_writers, "sql_insert": 1},
           "rows_acknowledged": acked, "count_read_back": count - LP_BODY_LINES,
           "lp_requests": int(lp_all.size),
           "lp_p50_ack_ms": float(np.percentile(lp_all, 50)),
           "lp_p99_ack_ms": float(np.percentile(lp_all, 99)),
           "sql_statements": len(sql_lat),
           "sql_p50_ack_ms": float(np.percentile(sql_lat, 50) * 1e3),
           "sql_p99_ack_ms": float(np.percentile(sql_lat, 99) * 1e3),
           "wal_fsyncs": plane["wal_fsyncs"],
           "group_commit": {ev: plane[ev] for ev in
                            ("lead", "follow", "overflow", "deadline")},
           "rows_a_commit": plane["commit_rows"] / plane["commits"]
           if plane["commits"] else None,
           "maintenance_jobs": plane["maintenance_jobs"],
           "stall_s": plane["stall_s"],
           "read_p50_idle_ms": float(np.median(idle)),
           "read_p50_loaded_ms": float(np.median(reads_ms)),
           "reads": reads, "k1_launches": int(k[0]),
           "k2_launches": int(k[1]), "errors": len(errors),
           "engine": {k: getattr(qe.region_engine.config, k) for k in (
               "write_workers", "ingest_group_commit", "ingest_overlap",
               "maintenance_workers")}}
    log(f"ingest_qps ({table}): " + json.dumps(out))
    check(not errors, f"ingest_qps: {len(errors)} errors, first {errors[:1]}")
    check(count == acked + LP_BODY_LINES,
          f"ingest_qps: count(*) {count}, acknowledged {acked} + "
          f"{LP_BODY_LINES} before the clock")
    # the two readers' identical statements may join one execution
    # (the batcher's coalescing), so K2 launches a read or fewer
    check(reads > 0 and 0 < int(k[1]) <= reads and int(k[0]) == 0,
          f"ingest_qps: {reads} reads launched K1 {int(k[0])}, K2 "
          f"{int(k[1])} times")
    return out


def remote_write_bodies(grid, host_names, p0, p1) -> list:
    """usage_user of points [p0, p1) for every host as snappy
    WriteRequests of RW_SAMPLES_PER_SEND samples (one sample a series a
    request, as one scrape's samples leave a Prometheus queue shard)."""
    import struct

    from greptimedb_tpu_torch.utils import protowire as pw
    from greptimedb_tpu_torch.utils import snappy

    name = pw.field_bytes(1, pw.field_str(1, "__name__")
                          + pw.field_str(2, "cpu_usage_user"))
    labels = [name + pw.field_bytes(1, pw.field_str(1, "hostname")
                                    + pw.field_str(2, h))
              for h in host_names]
    vals = grid["usage_user"][p0:p1].reshape(-1)
    packed = struct.pack(f"<{vals.size}d", *vals.tolist())
    bodies = []
    for lo in range(0, vals.size, RW_SAMPLES_PER_SEND):
        parts = []
        for r in range(lo, min(lo + RW_SAMPLES_PER_SEND, vals.size)):
            p, h = divmod(r, HOSTS)
            sample = (b"\x09" + packed[8 * r:8 * r + 8]
                      + pw.field_varint(2, T0_MS + (p0 + p) * STEP_S * 1000))
            parts.append(pw.field_bytes(
                1, labels[h] + pw.field_bytes(2, sample)))
        bodies.append(snappy.compress(b"".join(parts)))
    return bodies


def remote_read(port, queries) -> list:
    """One ReadRequest of `queries` [(start_ms, end_ms, [(type, name,
    value)])] -> per query {hostname: [(ts_ms, value)]}."""
    import http.client

    from greptimedb_tpu_torch.utils import protowire as pw
    from greptimedb_tpu_torch.utils import snappy

    body = b""
    for start, end, matchers in queries:
        q = pw.field_varint(1, start) + pw.field_varint(2, end)
        for mtype, name, value in matchers:
            q += pw.field_bytes(3, pw.field_varint(1, mtype)
                                + pw.field_str(2, name)
                                + pw.field_str(3, value))
        body += pw.field_bytes(1, q)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request("POST", "/v1/prometheus/read",
                     body=snappy.compress(body))
        resp = conn.getresponse()
        data = resp.read()
    finally:
        conn.close()
    check(resp.status == 200, f"remote read: HTTP {resp.status}")
    out = []
    for _, _, qr in pw.iter_fields(snappy.decompress(data)):
        series = {}
        for _, _, ts_blob in pw.iter_fields(qr):
            labels, samples = {}, []
            for f, _, v in pw.iter_fields(ts_blob):
                if f == 1:
                    kv = {f2: v2.decode() for f2, _, v2 in pw.iter_fields(v)}
                    labels[kv.get(1, "")] = kv.get(2, "")
                elif f == 2:
                    d = dict((f2, v2) for f2, _, v2 in pw.iter_fields(v))
                    samples.append((pw.varint_to_sint64(d.get(2, 0)),
                                    pw.fixed64_to_double(d.get(1, 0))))
            check(labels.get("__name__") == "cpu_usage_user",
                  f"remote read: labels {labels}")
            series[labels["hostname"]] = samples
        out.append(series)
    return out


def remote_write_phase(qe, sk, torch, grid, host_names, port,
                       t_phase) -> dict:
    """Part 4: the hour's usage_user as 4,000 series over remote write,
    two PromQL queries on the card against numpy, three remote reads bit
    for bit against what was sent. The points sent are cut (and the cut
    printed) when the phase would otherwise pass WRITE_PHASE_BUDGET_S."""
    from greptimedb_tpu_torch.promql.engine import PromqlEngine

    points = LP_HOURS * 3600 // STEP_S
    per_send = RW_SAMPLES_PER_SEND // HOSTS or 1
    # the first points serially: the cost of a point, to size the rest
    t = time.perf_counter()
    first = remote_write_bodies(grid, host_names, 0, per_send)
    sent0 = post_all(port, "/v1/prometheus/write", first, 1, {})
    per_point = (time.perf_counter() - t) / per_send
    left = WRITE_PHASE_BUDGET_S - RW_RESERVE_S \
        - (time.perf_counter() - t_phase)
    sent_points = int(min(points, max(12, per_send + left / per_point)))
    cut = None if sent_points == points else {
        "points_sent": sent_points, "points_in_the_hour": points,
        "reason": f"{per_point:.3f} s a point with {left:.1f} s left in "
                  f"the phase's {WRITE_PHASE_BUDGET_S:.0f} s budget"}
    t = time.perf_counter()
    bodies = remote_write_bodies(grid, host_names, per_send, sent_points)
    build_s = time.perf_counter() - t
    sent = post_all(port, "/v1/prometheus/write", bodies, RW_CLIENTS, {})
    status = sent0["status"] + sent["status"]
    check(status == [204] * len(status),
          f"remote write: not every request got 204 "
          f"({sent0['first_error'] + sent['first_error']})")
    samples = sent_points * HOSTS
    count = qe.execute_one("SELECT count(*) FROM cpu_usage_user").rows()[0][0]
    check(count == samples, f"remote write: count(*) {count}, expected "
          f"{samples}")
    out = {"samples": samples, "requests": len(status),
           "samples_a_request": RW_SAMPLES_PER_SEND, "clients": RW_CLIENTS,
           "build_s": build_s, "wall_s": sent["wall_s"],
           "samples_per_s": (samples - per_send * HOSTS) / sent["wall_s"],
           "ack_p50_ms": sent["p50_ms"], "ack_p99_ms": sent["p99_ms"],
           "cut": cut}
    log("write protocols: remote write: " + json.dumps(out))

    # PromQL on the card over what remote write stored
    user = grid["usage_user"][:sent_points].T  # [hosts, points]
    t0 = T0_MS // 1000
    grid_s = t0 + np.arange(sent_points) * float(STEP_S)
    t_end = t0 + (sent_points - 1) * STEP_S
    prom = PromqlEngine(qe)
    promql = {}
    k2 = 0
    for name, q, step, rng_s in (
            ("max_over_time", "max_over_time(cpu_usage_user[1h])", 300,
             3600),
            ("avg", "avg(cpu_usage_user)", 60, 300)):
        times = t0 + np.arange((t_end - t0) // step + 1) * float(step)
        sk.fused_segment_agg.launches = 0
        sync(torch)
        t = time.perf_counter()
        got_times, m = prom.eval_matrix(q, t0, t_end, float(step))
        sync(torch)
        cold_ms = (time.perf_counter() - t) * 1e3
        launched = sk.fused_segment_agg.launches
        k2 += launched
        check(np.array_equal(got_times, times), f"promql {name}: times")
        vals = m.values.cpu().numpy()
        if name == "avg":
            i0, i1 = window_index(grid_s, times, rng_s)
            want = np.where(i1 > i0, user[:, np.maximum(i1 - 1, 0)].mean(
                axis=0), np.nan)
            err = check_close(vals[0], want, 1e-9, f"promql {name}")
        else:
            hosts = host_index(np.asarray([lab["hostname"]
                                           for lab in m.labels]))
            check(np.array_equal(np.sort(hosts), np.arange(HOSTS)),
                  f"promql {name}: hostname labels")
            want = window_maxes(user, grid_s, times, rng_s)[hosts]
            check(np.array_equal(vals, want, equal_nan=True),
                  f"promql {name}: window maxes differ from numpy")
            err = 0.0
        warm = []
        for _ in range(3):
            sync(torch)
            t = time.perf_counter()
            prom.eval_matrix(q, t0, t_end, float(step))
            sync(torch)
            warm.append((time.perf_counter() - t) * 1e3)
        promql[name] = {"query": q, "step_s": step, "steps": len(times),
                        "cold_ms": cold_ms, "warm_p50_ms":
                        float(np.median(warm)), "k2_launches_cold": launched,
                        "window_paths": qe.executor.last_promql_paths,
                        "max_rel_err": err}
        check(launched >= 1, f"promql {name} over remote write launched "
              "no K2")
        log(f"write protocols: promql {name}: " + json.dumps(promql[name]))
    out["promql"] = promql
    out["k2_launches"] = k2

    # remote read: bit for bit against what was sent
    end_ms = T0_MS + (sent_points - 1) * STEP_S * 1000
    lo_p, hi_p = sent_points // 4, sent_points // 2
    reads = {
        "equality": (T0_MS, end_ms, [(0, "__name__", "cpu_usage_user"),
                                     (0, "hostname", "host_7")]),
        "regex": (T0_MS, end_ms, [(0, "__name__", "cpu_usage_user"),
                                  (2, "hostname", "host_1[0-9]")]),
        "time_range": (T0_MS + lo_p * STEP_S * 1000,
                       T0_MS + hi_p * STEP_S * 1000,
                       [(0, "__name__", "cpu_usage_user"),
                        (2, "hostname", "host_(2|3)")]),
    }
    t = time.perf_counter()
    got = remote_read(port, list(reads.values()))
    read_ms = (time.perf_counter() - t) * 1e3
    wants = {"equality": (["host_7"], 0, sent_points),
             "regex": ([f"host_1{d}" for d in range(10)], 0, sent_points),
             "time_range": (["host_2", "host_3"], lo_p, hi_p + 1)}
    for (name, (hosts, p0, p1)), series in zip(wants.items(), got):
        check(sorted(series) == sorted(hosts),
              f"remote read {name}: series {sorted(series)[:5]}")
        for h in hosts:
            ts = T0_MS + np.arange(p0, p1) * STEP_S * 1000
            vals = grid["usage_user"][p0:p1, int(h[5:])]
            check(series[h] == list(zip(ts.tolist(), vals.tolist())),
                  f"remote read {name}: {h}'s samples differ from those "
                  "sent")
    out["remote_read"] = {"queries": len(reads), "ms": read_ms,
                          "samples": sum(len(v) for s in got
                                         for v in s.values())}
    log("write protocols: remote read: " + json.dumps(out["remote_read"]))
    return out


def otlp_metrics_body() -> tuple:
    """A small OTLP ExportMetricsServiceRequest (a gauge, a sum with int
    points, a histogram) and the rows each table must hold."""
    import struct

    from greptimedb_tpu_torch.utils import protowire as pw

    def kv(k, v):
        return pw.field_str(1, k) + pw.field_bytes(2, pw.field_str(1, v))

    def fixed64(field, v):
        return pw.write_varint((field << 3) | 1) + struct.pack("<Q", v)

    rng = np.random.default_rng(SEED)
    gauge, sums, want = b"", b"", {}
    for i, v in enumerate(rng.uniform(0, 100, 8).tolist()):
        gauge += pw.field_bytes(1, pw.field_bytes(7, kv("host", f"h{i}"))
                                + fixed64(3, (T0_MS + i * 1000) * 10**6)
                                + pw.field_double(4, v))
        want.setdefault("otlp_gauge", []).append(
            [f"h{i}", "chip", T0_MS + i * 1000, v])
    for i, v in enumerate(rng.integers(0, 10**6, 4).tolist()):
        sums += pw.field_bytes(1, pw.field_bytes(7, kv("host", f"h{i}"))
                               + fixed64(3, (T0_MS + i * 1000) * 10**6)
                               + pw.write_varint((6 << 3) | 1)
                               + struct.pack("<q", v))
        want.setdefault("otlp_sum", []).append(
            [f"h{i}", "chip", T0_MS + i * 1000, float(v)])
    counts, bounds = [3, 5, 0, 2], [0.1, 1.0, 10.0]
    hist = pw.field_bytes(1, pw.field_bytes(9, kv("route", "/q"))
                          + fixed64(3, T0_MS * 10**6) + fixed64(4, 10)
                          + pw.field_double(5, 12.5)
                          + pw.field_bytes(6, struct.pack("<4Q", *counts))
                          + pw.field_bytes(7, struct.pack("<3d", *bounds)))
    cum = np.cumsum(counts).tolist()
    want["otlp_hist_bucket"] = sorted(
        [[le, "/q", "chip", T0_MS, float(c)]
         for le, c in zip(["0.1", "1.0", "10.0", "+Inf"], cum)])
    want["otlp_hist_sum"] = [["/q", "chip", T0_MS, 12.5]]
    want["otlp_hist_count"] = [["/q", "chip", T0_MS, 10.0]]
    metrics = (pw.field_str(1, "otlp.gauge") + pw.field_bytes(5, gauge),
               pw.field_str(1, "otlp.sum") + pw.field_bytes(7, sums),
               pw.field_str(1, "otlp.hist") + pw.field_bytes(9, hist))
    resource = pw.field_bytes(1, pw.field_bytes(1, kv("service", "chip")))
    scope = b"".join(pw.field_bytes(2, m) for m in metrics)
    return pw.field_bytes(1, resource + pw.field_bytes(2, scope)), want


OTLP_SPANS = 300


def otlp_traces_body() -> tuple:
    """OTLP_SPANS spans of a few traces, and their (trace_id, span_id,
    parent_span_id, span_name, duration_nano) rows."""
    import struct

    from greptimedb_tpu_torch.utils import protowire as pw

    rng = np.random.default_rng(SEED + 1)
    spans, want = b"", []
    for i in range(OTLP_SPANS):
        tid, sid = bytes([i % 5 + 1]) * 16, (i + 1).to_bytes(8, "big")
        parent = i.to_bytes(8, "big") if i % 5 else b""
        start = T0_MS * 10**6 + int(rng.integers(0, 10**9))
        dur = int(rng.integers(0, 10**8))
        span = (pw.field_bytes(1, tid) + pw.field_bytes(2, sid)
                + (pw.field_bytes(4, parent) if parent else b"")
                + pw.field_str(5, f"op{i % 7}") + pw.field_varint(6, 2)
                + pw.write_varint((7 << 3) | 1) + struct.pack("<Q", start)
                + pw.write_varint((8 << 3) | 1)
                + struct.pack("<Q", start + dur))
        spans += pw.field_bytes(2, span)
        want.append([tid.hex(), sid.hex(), parent.hex(), f"op{i % 7}",
                     float(dur)])
    scope = pw.field_bytes(1, pw.field_str(1, "chip") + pw.field_str(2, "1"))
    body = pw.field_bytes(1, pw.field_bytes(2, scope + spans))
    return body, sorted(want, key=lambda r: r[1])


def otlp_opentsdb_phase(qe, port) -> dict:
    """Part 5: an OTLP metrics request (gauge, sum, histogram), a traces
    request of OTLP_SPANS spans, OpenTSDB JSON puts over HTTP and `put`
    lines over the telnet server's socket, each read back with SQL and
    compared with what was sent."""
    import socket

    from greptimedb_tpu_torch.servers.opentsdb import OpentsdbServer

    def rows(sql):
        return [[float(v) if isinstance(v, np.floating) else
                 int(v) if isinstance(v, np.integer) else v for v in r]
                for r in qe.execute_one(sql).rows()]

    out = {}
    body, want = otlp_metrics_body()
    got = post_all(port, "/v1/otlp/v1/metrics", [body], 1, {})
    check(got["status"] == [200], f"otlp metrics: {got['first_error']}")
    for table, rs in want.items():
        cols = "le, route" if "bucket" in table else \
            "route" if "hist" in table else "host"
        have = rows(f"SELECT {cols}, service, ts, "
                    f"greptime_value FROM {table} ORDER BY {cols}")
        if "bucket" in table:
            have = sorted(have)
        check(have == rs, f"otlp {table}: {have[:3]} != {rs[:3]}")
    out["otlp_metrics_rows"] = sum(len(v) for v in want.values())

    body, want = otlp_traces_body()
    got = post_all(port, "/v1/otlp/v1/traces", [body], 1, {})
    check(got["status"] == [200], f"otlp traces: {got['first_error']}")
    have = rows("SELECT trace_id, span_id, parent_span_id, span_name, "
                "duration_nano FROM opentelemetry_traces ORDER BY span_id")
    check(have == want, f"otlp traces: {len(have)} rows, {have[:2]}")
    out["otlp_spans"] = len(have)

    rng = np.random.default_rng(SEED + 2)
    puts = [{"metric": "tsdb_http", "timestamp": T0_MS // 1000 + i,
             "value": v, "tags": {"host": f"h{i % 4}"}}
            for i, v in enumerate(rng.uniform(0, 100, 50).tolist())]
    got = post_all(port, "/v1/opentsdb/api/put",
                   [json.dumps(puts).encode()], 1, {})
    check(got["status"] == [200], f"opentsdb put: {got['first_error']}")
    have = rows("SELECT host, ts, greptime_value FROM "
                "tsdb_http ORDER BY ts")
    check(have == [[p["tags"]["host"], p["timestamp"] * 1000, p["value"]]
                   for p in puts], "opentsdb JSON puts: rows differ")
    out["opentsdb_http_rows"] = len(have)

    srv = OpentsdbServer(qe, port=0)
    srv.start()
    try:
        lines = [f"put tsdb_telnet {T0_MS // 1000 + i} {float(v)!r} "
                 f"host=h{i % 3}"
                 for i, v in enumerate(rng.uniform(0, 100, 50).tolist())]
        with socket.create_connection(("127.0.0.1", srv.port),
                                      timeout=60) as s:
            s.sendall(("\n".join(lines + ["exit"]) + "\n").encode())
            answer = s.makefile("rb").read()
    finally:
        srv.shutdown()
    check(answer == b"", f"opentsdb telnet answered {answer[:200]!r}")
    have = rows("SELECT host, ts, greptime_value FROM "
                "tsdb_telnet ORDER BY ts")
    want = [[ln.split()[4][5:], int(ln.split()[2]) * 1000,
             float(ln.split()[3])] for ln in lines]
    check(have == want, "opentsdb telnet puts: rows differ")
    out["opentsdb_telnet_rows"] = len(have)
    log("write protocols: otlp and opentsdb: " + json.dumps(out))
    return out


def native_line() -> dict:
    """The native host library: built with g++ here, CRC32 over 64 MiB
    against zlib, and the snappy codec timed against the pure-Python one
    on one remote-write body."""
    import zlib

    from greptimedb_tpu_torch import native
    from greptimedb_tpu_torch.utils import snappy

    t = time.perf_counter()
    lib = native.try_load()
    load_s = time.perf_counter() - t
    check(lib is not None and native.AVAILABLE,
          "native: the g++ build of greptimedb_tpu_torch/native failed")
    data = np.random.default_rng(SEED).integers(
        0, 256, 64 << 20, dtype=np.uint8).tobytes()
    t = time.perf_counter()
    got = native.crc32(data)
    crc_native_s = time.perf_counter() - t
    t = time.perf_counter()
    want = zlib.crc32(data)
    crc_zlib_s = time.perf_counter() - t
    check(got == want, f"native crc32 {got:#x} != zlib {want:#x}")
    grid = {"usage_user": np.random.default_rng(SEED).uniform(
        0, 100, (1, HOSTS))}
    body = remote_write_bodies(grid, [f"host_{h}" for h in range(HOSTS)],
                               0, 1)[0]
    raw = snappy.decompress(body)
    times = {}
    for name, fn, arg in (
            ("native_compress", native.snappy_compress, raw),
            ("python_compress", snappy._py_compress, raw),
            ("native_decompress", native.snappy_decompress, body),
            ("python_decompress", snappy._py_decompress, body)):
        t = time.perf_counter()
        for _ in range(5):
            res = fn(arg)
        times[name + "_ms"] = (time.perf_counter() - t) / 5 * 1e3
        if name.endswith("decompress"):
            check(res == raw, f"snappy {name} differs")
        else:
            check(snappy.decompress(res) == raw, f"snappy {name} roundtrip")
    out = {"available": native.AVAILABLE, "load_s": load_s,
           "crc32_mib": 64, "crc32_native_ms": crc_native_s * 1e3,
           "crc32_zlib_ms": crc_zlib_s * 1e3, "crc32_equal": True,
           "snappy_body_bytes": len(raw), **times}
    log("write protocols: native: " + json.dumps(out))
    return out


def write_protocols_phase(qe, sk, torch, grid, host_names) -> dict:
    """(e) the write protocols on the main path's engine, with the JAX
    defaults (plan cache and fast lane) and the partial cache off where
    launches are counted: the hour of `cpu` as line protocol through the
    HTTP server into cpu_lp and bench.py's six queries over it, bench.py's
    ingest_qps traffic in process, Prometheus remote write with PromQL and
    remote read over it, OTLP and OpenTSDB. No server thread outlives
    the phase."""
    import threading

    from greptimedb_tpu_torch.servers import HttpServer

    t_phase = time.perf_counter()
    before = set(threading.enumerate())
    out = {"native": native_line()}
    with defaults_plane(qe):
        srv = HttpServer(qe, port=0)
        port = srv.start()
        try:
            out["cpu_lp"] = cpu_lp_phase(qe, sk, torch, grid, host_names,
                                         port)
            with partial_cache(False):
                out["ingest_qps"] = ingest_qps_phase(qe, sk, torch)
            out["remote_write"] = remote_write_phase(
                qe, sk, torch, grid, host_names, port, t_phase)
            out["otlp_opentsdb"] = otlp_opentsdb_phase(qe, port)
        finally:
            srv.stop()
    left = [t for t in set(threading.enumerate()) - before if t.is_alive()]
    check(not left, f"write protocols: threads outlived the servers: "
          f"{sorted(t.name for t in left)}")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"write protocols: phase took {out['phase_s']:.1f} s "
        f"(budget {WRITE_PHASE_BUDGET_S:.0f} s)")
    return out


# ---- (f) the write plane: group commit, the maintenance plane, rollups ----

#: rows of each of the retention table's two SSTs
TTL_ROWS = 1000


def defaults_engine(root, **overrides):
    """The engine `standalone start` builds from its default options
    (cpu/2 write workers, group commit with overlap, one maintenance
    worker) over the main path's data dir, on DEVICE. `overrides` maps
    option paths to values ("ingest.group_commit": False); the decoded
    part cache keeps the main path's budget."""
    from greptimedb_tpu_torch import options
    from greptimedb_tpu_torch.catalog import Catalog, FileKv
    from greptimedb_tpu_torch.query import QueryEngine
    from greptimedb_tpu_torch.storage import RegionEngine

    opts = options.StandaloneOptions()
    opts.scan.part_cache_bytes = PART_CACHE_BYTES
    for path, value in overrides.items():
        section, key = path.split(".")
        setattr(getattr(opts, section), key, value)
    options.check_port_support(opts)
    engine = RegionEngine(options.engine_config(
        opts, os.path.join(root, "data")), device=DEVICE)
    qe = QueryEngine(Catalog(FileKv(os.path.join(root, "catalog.json"))),
                     engine, device=DEVICE)
    return engine, qe


def plane_threads() -> list:
    import threading

    return sorted(t.name for t in threading.enumerate()
                  if t.name.startswith(("gtpu-maint", "gtpu-write-worker")))


def write_plane_ingest(root, sk, torch, table, **overrides) -> dict:
    """bench.py's ingest_qps (ingest_qps_phase) on an engine with
    standalone's default options plus `overrides`, the JAX defaults of
    the concurrency plane, the partial cache off; then the maintenance
    plane drains and the engine closes, joining every plane thread."""
    engine, qe = defaults_engine(root, **overrides)
    try:
        check(engine.workers is not None and engine.maintenance is not None,
              "write plane: standalone's defaults built no write workers "
              "or no maintenance plane")
        with defaults_plane(qe), partial_cache(False):
            out = ingest_qps_phase(qe, sk, torch, table)
        t = time.perf_counter()
        check(engine.maintenance.wait_idle(timeout=300),
              f"write plane ({table}): the maintenance plane did not drain")
        jobs = [j.to_dict() for j in engine.maintenance.jobs()]
        out["jobs"] = [{k: j[k] for k in ("kind", "state", "duration_ms")}
                       for j in jobs]
        out["drain_s"] = time.perf_counter() - t
        check(all(j["state"] == "done" for j in jobs),
              f"write plane ({table}): a maintenance job failed: {jobs}")
    finally:
        engine.close()
    check(not plane_threads(),
          f"write plane: threads outlived close(): {plane_threads()}")
    log(f"write plane ingest ({table}, {overrides or 'defaults'}): "
        + json.dumps({k: out[k] for k in ("jobs", "drain_s")}))
    return out


def coarse_sql() -> str:
    """bench.py's rollup query (bench.py:985) over `cpu`: min, max, sum
    and count(*) of usage_user by host and 5-minute bin, over the rolled
    hours."""
    t_end = T0_MS + HOURS * 3600 * 1000
    return ("SELECT hostname, date_bin(INTERVAL '5 minutes', ts) AS b, "
            "min(usage_user), max(usage_user), sum(usage_user), count(*) "
            f"FROM cpu WHERE ts >= {T0_MS} AND ts < {t_end} "
            "GROUP BY hostname, b ORDER BY hostname, b")


def check_coarse(res, grid, what) -> None:
    """The coarse query against numpy over the first HOURS of points:
    keys, min and max exactly (as float32 computes them), count exactly,
    sums to rtol 1e-5 (float32 accumulation)."""
    order = np.argsort(np.asarray([f"host_{i}" for i in range(HOSTS)]),
                       kind="stable")
    bins = HOURS * 12
    window = grid["usage_user"][:HOURS * 3600 // STEP_S]
    v = window.reshape(bins, 300 // STEP_S, HOSTS)[:, :, order]
    cols = {n: np.asarray(c) for n, c in zip(res.names, res.columns)}
    check(res.num_rows == HOSTS * bins, f"{what}: {res.num_rows} rows")
    check(np.array_equal(host_index(cols["hostname"]),
                         np.repeat(order, bins)), f"{what}: hostname keys")
    check(np.array_equal(cols["b"], np.tile(
        T0_MS + np.arange(bins) * 300_000, HOSTS)), f"{what}: bin keys")
    for name, want in (("min(usage_user)", v.min(axis=1)),
                       ("max(usage_user)", v.max(axis=1))):
        check(np.array_equal(cols[name].astype(np.float64),
                             f32_exact(want.T.reshape(-1))),
              f"{what}: {name}")
    check(np.all(cols["count(*)"] == 300 // STEP_S), f"{what}: count(*)")
    want = v.sum(axis=1).T.reshape(-1)
    got = cols["sum(usage_user)"].astype(np.float64)
    check(np.allclose(got, want, rtol=1e-5, atol=0),
          f"{what}: sum, max rel err "
          f"{np.max(np.abs(got - want) / np.abs(want))}")


def rows_agree(a, b, what) -> None:
    """Two results of one statement (the raw route, the substituted one):
    the same names and keys, equal counts, extremes and values to rtol
    1e-5 (both compute in float32 on the card)."""
    check(a.names == b.names and a.num_rows == b.num_rows,
          f"{what}: {a.names} x {a.num_rows} vs {b.names} x {b.num_rows}")
    for name, x, y in zip(a.names, a.columns, b.columns):
        x, y = np.asarray(x), np.asarray(y)
        if x.dtype == object or np.issubdtype(x.dtype, np.integer):
            check(np.array_equal(x, y), f"{what}: {name}")
        elif name.startswith(("min(", "max(")):
            check(np.array_equal(x.astype(np.float32), y.astype(np.float32)),
                  f"{what}: {name}")
        else:
            check(np.allclose(x, y, rtol=1e-5, atol=0), f"{what}: {name}")


def check_planes(engine, rid, rrid, grid) -> dict:
    """The companion region's plane rows against numpy over the rolled
    minutes: f__min, f__max exactly, f__count and rows__count exactly,
    f__sum to rtol 1e-12 (K2 sums float64 in another order)."""
    scan = engine.scan(rrid)
    minutes = HOURS * 60
    check(scan is not None and scan.num_rows == HOSTS * minutes,
          f"rollup: {0 if scan is None else scan.num_rows} plane rows")
    host = host_index(scan.tag_dicts["hostname"][scan.columns["hostname"]])
    minute = (scan.columns["ts"].astype(np.int64) - T0_MS) // 60_000
    check(minute.min() == 0 and minute.max() == minutes - 1,
          "rollup: plane minutes")
    at = minute * HOSTS + host
    check(np.array_equal(np.sort(at), np.arange(HOSTS * minutes)),
          "rollup: one plane row a host and minute")
    order = np.argsort(at)
    check(np.all(scan.columns["rows__count"][order] == 60 // STEP_S),
          "rollup: rows__count")
    worst = 0.0
    for f in FIELDS:
        v = grid[f][:minutes * 60 // STEP_S].reshape(minutes, -1, HOSTS)
        for plane, want in (("min", v.min(axis=1)), ("max", v.max(axis=1))):
            check(np.array_equal(scan.columns[f"{f}__{plane}"][order],
                                 want.reshape(-1)), f"rollup: {f}__{plane}")
        check(np.all(scan.columns[f"{f}__count"][order] == 60 // STEP_S),
              f"rollup: {f}__count")
        want = v.sum(axis=1).reshape(-1)
        got = scan.columns[f"{f}__sum"][order]
        err = float(np.max(np.abs(got - want) / np.abs(want)))
        check(err <= 1e-12, f"rollup: {f}__sum rel err {err}")
        worst = max(worst, err)
    return {"plane_rows": scan.num_rows, "sum_max_rel_err": worst}


def substitution_runs(qe, sk, torch, grid, name, sql) -> dict:
    """`sql` through the rollup planes and through the raw route
    (GTPU_ROLLUP_SUBSTITUTE=0): cold with each route's kernel launches,
    warm p50 of 5, every value against numpy and the routes against each
    other."""
    out = {}
    results = {}
    for route, flag in (("substituted", "1"), ("raw", "0")):
        with env_value("GTPU_ROLLUP_SUBSTITUTE", flag), \
                partial_cache(False):
            k0 = launches(sk)
            res, cold = timed_query(qe, sql, torch)
            k = np.subtract(launches(sk), k0)
            path = qe.executor.last_path or ""
            warm = [timed_query(qe, sql, torch)[1] for _ in range(5)]
            host = host_breakdown(lambda: qe.execute_one(sql), top=6)
        check(("+rollup" in path) == (route == "substituted"),
              f"{name} {route}: last_path {path!r}")
        check(int(k[0]) + int(k[1]) > 0,
              f"{name} {route}: no kernel was launched")
        if name == "double_groupby_all":
            check_result(name, res, grid)
        else:
            check_coarse(res, grid, f"{name} {route}")
        results[route] = res
        out[route] = {"last_path": path, "cold_ms": cold,
                      "warm_p50_ms": float(np.median(warm)),
                      "k1_launches": int(k[0]), "k2_launches": int(k[1]),
                      "host": host}
    rows_agree(results["substituted"], results["raw"], f"{name} routes")
    log(f"rollup substitution {name}: " + json.dumps(out))
    return out


def rollup_phase(root, sk, torch, grid) -> dict:
    """ADMIN rollup_table('cpu', '1m') on the 17.28 M-row `cpu` table
    after its compaction: one job, one K2 launch, the planes against
    numpy; then the two substituted queries; then retention on a small
    TTL table."""
    from greptimedb_tpu_torch.maintenance.rollup import (
        rollup_region_id,
        rule_slot,
    )

    engine, qe = defaults_engine(root)
    try:
        info = qe.catalog.table("public", "cpu")
        rid = info.region_ids[0]
        maint = engine.maintenance
        zero_launches(sk)
        r = qe.execute_one("ADMIN rollup_table('cpu', '1m')")
        job_id = int(r.rows()[0][0])
        if DEVICE == "cpu":  # a CPU rehearsal: no CUPTI to read
            maint.wait(job_id, timeout=900)
            prof = {"top": []}
        else:
            prof = device_breakdown(
                lambda: maint.wait(job_id, timeout=900), torch)
        job = maint.job(job_id)
        k = launches(sk)
        check(job.state == "done", f"rollup job: {job.state} {job.error}")
        check(k == (0, 1), f"rollup job launched K1 {k[0]}, K2 {k[1]} "
              "times: one K2 call a job")
        k2_ms = sum(v for n, v in prof["top"] if "fused_" in n)
        rollup = {"job_ms": job.duration_ms, "detail": job.detail,
                  "k1_launches": k[0], "k2_launches": k[1],
                  "k2_device_ms": k2_ms, "profile": prof}
        rrid = rollup_region_id(rid, rule_slot(60_000))
        rollup.update(check_planes(engine, rid, rrid, grid))
        check(job.detail["rows_out"] == rollup["plane_rows"],
              f"rollup: rows_out {job.detail['rows_out']}")
        log("rollup (cpu, 1m): " + json.dumps(rollup))
        subs = {"coarse": substitution_runs(qe, sk, torch, grid, "coarse",
                                            coarse_sql()),
                "double_groupby_all": substitution_runs(
                    qe, sk, torch, grid, "double_groupby_all",
                    tsbs_queries()["double_groupby_all"][0])}
        retention = retention_phase(qe, engine)
    finally:
        engine.close()
    check(not plane_threads(),
          f"write plane: threads outlived close(): {plane_threads()}")
    return {"rollup": rollup, "substitution": subs, "retention": retention}


def retention_phase(qe, engine) -> dict:
    """ADMIN expire_table on a small table of two SSTs, one ten days old:
    the old SST goes whole, the new one stays whole, count(*) follows."""
    maint = engine.maintenance

    def run(sql):
        r = qe.execute_one(sql)
        jobs = [maint.wait(int(row[0]), timeout=60) for row in r.rows()]
        check(all(j.state == "done" for j in jobs),
              f"{sql}: {[j.error for j in jobs]}")
        return jobs

    qe.execute_one("CREATE TABLE ttl_t (host STRING, v DOUBLE, "
                   "ts TIMESTAMP(3) TIME INDEX, PRIMARY KEY(host))")
    now = int(time.time() * 1000)
    for t0 in (now - 10 * 86_400_000, now - TTL_ROWS):
        qe.execute_one("INSERT INTO ttl_t (host, v, ts) VALUES " + ", ".join(
            f"('h{i % 7}', {i}.5, {t0 + i})" for i in range(TTL_ROWS)))
        run("ADMIN flush_table('ttl_t')")
    region = engine.region(qe.catalog.table("public",
                                            "ttl_t").region_ids[0])
    files = sorted(region.files.values(), key=lambda m: m.ts_max)
    check(len(files) == 2, f"retention: {len(files)} SSTs before expiry")
    (job,) = run("ADMIN expire_table('ttl_t', '7d')")
    count = qe.execute_one("SELECT count(*) FROM ttl_t").rows()[0][0]
    out = {"removed": job.detail["removed"], "ssts_left": len(region.files),
           "count": count, "job_ms": job.duration_ms}
    log("retention (ttl_t, 7d): " + json.dumps(out))
    check(out["removed"] == 1 and set(region.files) == {files[1].file_id}
          and count == TTL_ROWS,
          "retention: expiry did not drop exactly the old SST whole")
    return out


def write_plane_phase(root, sk, torch, grid) -> dict:
    """(f) the write plane on the main path's data dir, after the other
    phases: bench.py's ingest_qps with standalone's defaults and again
    with ingest.group_commit = false, then the rollup, substitution and
    retention of rollup_phase."""
    t_phase = time.perf_counter()
    out = {"ingest_defaults": write_plane_ingest(
               root, sk, torch, "ingestq_gc"),
           "ingest_serial": write_plane_ingest(
               root, sk, torch, "ingestq_serial",
               **{"ingest.group_commit": False})}
    d, s = out["ingest_defaults"], out["ingest_serial"]
    check(d["group_commit"]["lead"] > 0 and s["group_commit"]["lead"] == 0,
          "write plane: group commit events "
          f"{d['group_commit']} / {s['group_commit']}")
    out.update(rollup_phase(root, sk, torch, grid))
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"write plane: phase took {out['phase_s']:.1f} s")
    return out


def first_query_breakdown(base, token, tid) -> dict:
    """A served process's first query, from its own observability
    surfaces: the span tree and ledger of its trace (/v1/traces) and
    the flame sampler's stages and hottest frames (/v1/profile/cluster),
    logged."""
    import urllib.request

    def get(path):
        req = urllib.request.Request(base + path)
        req.add_header("Authorization", "Basic " + token)
        deadline = time.time() + 10
        while True:
            try:
                with urllib.request.urlopen(req, timeout=60) as r:
                    return json.loads(r.read())
            except urllib.error.HTTPError as e:
                # the root span records just after the response is sent
                if e.code != 404 or time.time() > deadline:
                    raise
                time.sleep(0.05)

    import urllib.error

    doc = get(f"/v1/traces/{tid}")
    spans = {s["name"]: s for s in doc["spans"]}
    check("http:/v1/sql" in spans and "stmt:Select" in spans,
          f"standalone -c: the first query's trace has {sorted(spans)}")
    view = get("/v1/profile/cluster")["merged"]
    out = {"tree": doc["tree"],
           "ms": {name: s["duration_ms"] for name, s in spans.items()},
           "ledger": spans["stmt:Select"]["attrs"].get("ledger", ""),
           "flame_stages": view["stages"], "flame_top": view["top"][:8]}
    log("standalone -c: the first query's span tree (its own "
        "/v1/traces):\n" + "\n".join(doc["tree"]))
    log("standalone -c: the first query's ledger and the flame sampler "
        "since boot: " + json.dumps({k: v for k, v in out.items()
                                     if k != "tree"}))
    return out


def standalone_options_phase(root, answers, grid, rid) -> dict:
    """(d) `standalone start -c <toml>` over the closed cpu_1h dir, with
    Arrow Flight, MySQL, Postgres and one static user enabled and the JAX
    defaults of the concurrency plane: /v1/sql answers 401 without
    credentials and the in-process body with them; MySQL logs in with the
    right password and is refused with a wrong one; Postgres answers a
    query; the Flight legs (`flight_legs`) run; the `dump-config` text
    loads back to the defaults; SIGTERM ends it with exit code 0. TLS is
    left out here (the CPU tests drive it)."""
    import base64
    import shutil
    import tempfile
    import urllib.error
    import urllib.request

    from greptimedb_tpu_torch import options

    log("TLS: left out of chip_smoke.py; tests/test_torch_auth.py drives "
        "MySQL and Postgres over TLS on the CPU")
    user, password = STATIC_USER
    cfg_dir = tempfile.mkdtemp(prefix="chip_smoke_cfg_")
    env = {k: v for k, v in os.environ.items() if k not in LANE_OFF}
    env["PYTHONPATH"] = HERE
    dump = subprocess.run([sys.executable, "-m", "greptimedb_tpu_torch",
                           "dump-config"], cwd=HERE, env=env,
                          capture_output=True, text=True, timeout=120)
    dumped = os.path.join(cfg_dir, "dumped.toml")
    with open(dumped, "w") as f:
        f.write(dump.stdout)
    loaded = options.load_options(dumped, env={})
    check(dump.returncode == 0 and loaded == options.StandaloneOptions(),
          "dump-config: its text does not load back to the defaults")
    options.check_port_support(loaded)
    t = time.perf_counter()
    front = Frontend("standalone", root, cfg_dir, env,
                     extra=f"[auth]\nstatic_users = '{user}={password}'\n",
                     flight=True)
    try:
        front.wait_ready()
        start_s = front.start_s
        base = f"http://127.0.0.1:{front.port}"
        token = base64.b64encode(f"{user}:{password}".encode()).decode()
        # the /v1/sql answer only: phase (c) already held the PromQL one
        path, data, want = answers[0]
        steps = {}
        t_step = time.perf_counter()
        try:
            urllib.request.urlopen(urllib.request.Request(base + path,
                                                          data=data),
                                   timeout=120)
            status = 200
        except urllib.error.HTTPError as e:
            status = e.code
        check(status == 401, f"standalone -c: /v1/sql without credentials "
              f"answered {status}")
        steps["http_401_s"] = time.perf_counter() - t_step
        t_step = time.perf_counter()
        # the process's first query, traced: its span tree and ledger say
        # where its time goes
        tid = f"{os.getpid():08x}f1f57a11"[-16:]
        req = urllib.request.Request(base + path, data=data)
        req.add_header("Authorization", "Basic " + token)
        req.add_header("traceparent",
                       f"00-{tid.rjust(32, '0')}-00f067aa0ba902b7-01")
        with urllib.request.urlopen(req, timeout=120) as r:
            body = r.read()
        check(r.status == 200 and strip_time(body) == want,
              f"standalone -c {path}: the body differs from the in-process "
              "answer")
        steps["http_sql_s"] = time.perf_counter() - t_step
        first = first_query_breakdown(base, token, tid)
        t_step = time.perf_counter()
        rows = HOSTS * SERVE_HOURS * 3600 // STEP_S
        my = WireMysql(front.my_port, user, password)
        check(my.query("SELECT count(*) FROM cpu")
              == ("rows", ["count(*)"], [[str(rows)]]),
              "standalone -c: MySQL count(*)")
        my.close()
        try:
            WireMysql(front.my_port, user, "wrong")
            refused = None
        except WireError as e:
            refused = str(e)
        check(refused is not None and "mysql error 1045" in refused,
              f"standalone -c: a wrong MySQL password got {refused!r}")
        pg = WirePg(front.pg_port, user, password)
        check(pg.query("SELECT count(*) FROM cpu")
              == (["count(*)"], [[str(rows)]], "SELECT 1"),
              "standalone -c: Postgres count(*)")
        pg.close()
        steps["mysql_postgres_s"] = time.perf_counter() - t_step
        flight = flight_legs(front, token, grid, rid)
        steps["flight_s"] = flight["seconds"]
        requests_s = time.perf_counter() - t - start_s
        t_stop = time.perf_counter()
        rc = front.stop()
        stop_s = time.perf_counter() - t_stop
    finally:
        front.close()
        shutil.rmtree(cfg_dir, ignore_errors=True)
    out = {"start_s": start_s, "requests_s": requests_s, "stop_s": stop_s,
           "steps": steps, "first_query": first, "http_requests": 2,
           "mysql_logins": 2, "postgres_queries": 1, "exit_code": rc,
           "wall_s": time.perf_counter() - t, "flight": flight}
    log("serving standalone -c subprocess: " + json.dumps(
        {k: v for k, v in out.items() if k != "flight"}))
    return out


# ---- (d) Arrow Flight on the standalone's cpu_1h --------------------------------

#: the hour the Flight do_put writes into a fresh table, and its seed
FLIGHT_PUT_POINTS = 3600 // STEP_S
FLIGHT_PUT_SEED = 37


def flight_dga_sql(table: str) -> str:
    """double_groupby_all at 10-minute bins over the first hour: 4,000
    hosts x 6 bins = 24,000 groups (G+1 = 24,001), past K2's envelope,
    so K1."""
    avg_list = ", ".join(f"avg({f})" for f in FIELDS)
    return (f"SELECT date_bin(INTERVAL '10 minutes', ts) AS bin, hostname, "
            f"{avg_list} FROM {table} WHERE ts >= {T0_MS} "
            f"AND ts < {T0_MS + 3600 * 1000} "
            "GROUP BY bin, hostname ORDER BY bin, hostname")


def http_rows(port, token, sql) -> tuple:
    """(column names, rows) of one authenticated POST /v1/sql."""
    import urllib.parse
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/sql",
        data=urllib.parse.urlencode({"sql": sql}).encode())
    req.add_header("Authorization", "Basic " + token)
    with urllib.request.urlopen(req, timeout=300) as r:
        doc = json.loads(r.read())
    rec = doc["output"][0]["records"]
    return [c["name"] for c in rec["schema"]["column_schemas"]], rec["rows"]


def check_flight_rows(name, res, names, rows) -> float:
    """A Flight result equals the HTTP rows of the same statement: avg
    columns to rtol 1e-5 (K1's float atomics), every other cell exactly.
    Returns the largest relative difference of an avg cell."""
    got = res.rows()
    check(list(res.names) == list(names) and len(got) == len(rows),
          f"(d) flight {name}: {list(res.names)} x {len(got)} against "
          f"{names} x {len(rows)}")
    worst = 0.0
    for j, col in enumerate(names):
        g = [r[j] for r in got]
        w = [r[j] for r in rows]
        if col.startswith("avg("):
            g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
            check(np.allclose(g, w, rtol=1e-5, atol=0),
                  f"(d) flight {name}: {col}")
            worst = max(worst, float(np.max(np.abs(g - w) / np.abs(w))))
        else:
            check(g == w, f"(d) flight {name}: {col} differs")
    return worst


def check_grid_rows(ts_ms, host, values, grid, p0, p1, hosts, what) -> None:
    """Rows (ms timestamps, host indexes, {field: values}) hold exactly
    points [p0, p1) of the first `hosts` hosts of `grid`, in any order."""
    check(len(ts_ms) == (p1 - p0) * hosts,
          f"{what}: {len(ts_ms)} rows, expected {(p1 - p0) * hosts}")
    pts = (ts_ms - T0_MS) // (STEP_S * 1000) - p0
    order = np.lexsort((host, pts))
    check(np.array_equal(host[order], np.tile(np.arange(hosts), p1 - p0))
          and np.array_equal(pts[order],
                             np.repeat(np.arange(p1 - p0), hosts)),
          f"{what}: row keys")
    for f in FIELDS:
        got = np.asarray(values[f]).astype(np.float64)[order]
        check(np.array_equal(got, grid[f][p0:p1, :hosts].reshape(-1)),
              f"{what}: {f} values")


def check_scan_rows(scan, grid, p0, p1, hosts, what) -> None:
    """A region scan (ScanData) holds exactly those rows."""
    host = host_index(scan.tag_dicts["hostname"])[scan.columns["hostname"]]
    check_grid_rows(np.asarray(scan.columns["ts"], np.int64), host,
                    scan.columns, grid, p0, p1, hosts, what)


def flight_put_table(host_names, rng) -> tuple:
    """One hour of `cpu` for every host as a column table (hostname a
    dictionary column, ts timestamp[ms], the ten double fields) and its
    [points, hosts] grid."""
    from greptimedb_tpu_torch.datasource import TextColumn, TextTable

    n = FLIGHT_PUT_POINTS * HOSTS
    cols = {"hostname": TextColumn.of_codes(
                np.tile(np.arange(HOSTS, dtype=np.int32), FLIGHT_PUT_POINTS),
                host_names),
            "ts": TextColumn(np.repeat(T0_MS + np.arange(
                FLIGHT_PUT_POINTS, dtype=np.int64) * STEP_S * 1000, HOSTS),
                None, "timestamp[ms]")}
    grid = {}
    for f in FIELDS:
        vals = rng.uniform(0.0, 100.0, n)
        cols[f] = TextColumn(vals, None, "double")
        grid[f] = vals.reshape(FLIGHT_PUT_POINTS, HOSTS)
    return TextTable(["hostname", "ts", *FIELDS], cols, n), grid


def flight_legs(front, token, grid, rid) -> dict:
    """Arrow Flight against phase (d)'s standalone, with the port's own
    clients: the handshake (a wrong password refused); do_get of
    double_groupby_all at 10-minute bins (K1), cpu_max_all_8 and
    single_groupby_1_1_1 (K2), each equal to the same server's /v1/sql;
    a region_scan of the whole cpu_1h region against the generator's
    rows (MB/s); a do_put of one more hour (1,440,000 rows) into a fresh
    table, its count(*) equal to the acknowledged rows and
    double_groupby_all over it against numpy (rows/s); the server's K1
    and K2 launches from its /metrics before and after."""
    from greptimedb_tpu_torch.servers import flight

    user, password = STATIC_USER
    addr = f"127.0.0.1:{front.flight_port}"
    t = time.perf_counter()
    before = kernel_launches(scrape(front.port))
    client = flight.FlightQueryClient(addr, user, password)
    try:
        flight.FlightQueryClient(addr, user, "wrong")
        refused = None
    except flight.FlightUnauthenticatedError as e:
        refused = str(e)
    check(refused is not None, "(d) flight: a wrong password was accepted")
    out: dict = {"handshake_refused": refused}
    queries = {"double_groupby_all (10 min)": flight_dga_sql("cpu")}
    tq = tsbs_queries()
    for name in ("cpu_max_all_8", "single_groupby_1_1_1"):
        queries[name] = tq[name][0]
    for name, sql in queries.items():
        t_q = time.perf_counter()
        res = client.sql(sql)
        ms = (time.perf_counter() - t_q) * 1000
        names, rows = http_rows(front.port, token, sql)
        out[name] = {"rows": res.num_rows, "ms": ms,
                     "max_rel_err_avg": check_flight_rows(name, res, names,
                                                          rows)}
    check(out["double_groupby_all (10 min)"]["rows"] == HOSTS * 6,
          "(d) flight double_groupby_all: rows")
    remote = flight.RemoteRegionEngine(addr, user, password)
    try:
        t_s = time.perf_counter()
        scan = remote.scan(rid)
        scan_s = time.perf_counter() - t_s
    finally:
        remote.close()
    points = SERVE_HOURS * 3600 // STEP_S
    check_scan_rows(scan, grid, 0, points, HOSTS, "(d) flight region_scan")
    nbytes = sum(np.asarray(c).nbytes for c in scan.columns.values())         + scan.seq.nbytes + scan.op_type.nbytes
    out["region_scan"] = {"rows": scan.num_rows, "bytes": nbytes,
                          "seconds": scan_s, "mb_per_s": nbytes / scan_s / 1e6}
    del scan
    host_names = np.asarray([f"host_{i}" for i in range(HOSTS)],
                            dtype=object)
    table, put_vals = flight_put_table(
        host_names, np.random.default_rng(FLIGHT_PUT_SEED))
    client.sql(cpu_ddl().replace("TABLE cpu (", "TABLE cpu_flight ("))
    t_p = time.perf_counter()
    acked = client.insert("cpu_flight", table)
    put_s = time.perf_counter() - t_p
    del table
    check(acked == FLIGHT_PUT_POINTS * HOSTS, f"(d) flight do_put: {acked}")
    count = client.sql("SELECT count(*) FROM cpu_flight").rows()[0][0]
    check(count == acked, f"(d) flight do_put: count(*) {count}, acked "
          f"{acked}")
    res = client.sql(flight_dga_sql("cpu_flight"))
    order = np.argsort(host_names.astype(str), kind="stable")
    cols = [np.asarray(c) for c in res.columns]
    check(res.num_rows == HOSTS * 6 and np.array_equal(
        host_index(cols[1][:HOSTS]), order), "(d) flight do_put: groups")
    worst = 0.0
    for j, f in enumerate(FIELDS):
        want = put_vals[f].reshape(6, FLIGHT_PUT_POINTS // 6, HOSTS).mean(
            axis=1)[:, order].reshape(-1)
        got = cols[2 + j].astype(np.float64)
        check(np.allclose(got, want, rtol=1e-5, atol=0),
              f"(d) flight do_put: avg({f}) against numpy")
        worst = max(worst, float(np.max(np.abs(got - want) / want)))
    out["do_put"] = {"rows": acked, "seconds": put_s,
                     "rows_per_s": acked / put_s,
                     "max_rel_err_avg": worst}
    client.close()
    after = kernel_launches(scrape(front.port))
    out["k1_launches"] = after["segment_sum"] - before["segment_sum"]
    out["k2_launches"] = after["fused_segment_agg"] \
        - before["fused_segment_agg"]
    if DEVICE is None:
        check(out["k1_launches"] > 0 and out["k2_launches"] > 0,
              f"(d) flight: the server's launches {out['k1_launches']}, "
              f"{out['k2_launches']}")
    out["seconds"] = time.perf_counter() - t
    log("(d) flight on the standalone: " + json.dumps(out))
    return out


# ---- (i) the serving fabric: two frontends on one shared-memory fabric --------

#: requests in each frontend's round of the mixed traffic, and the
#: clients a tenant: a short round, enough for every tenant's template to
#: be built (second sighting) and then hit
FABRIC_REQUESTS = 90
FABRIC_CLIENTS = 2
#: the parameters B's round is shifted by (other hosts than A's)
FABRIC_OFFSET = 1000
#: the least rows of the result sent through the result arena
FABRIC_BIG_ROWS = 100_000
#: the JAX default a segment (the artifact fabric and the result arena
#: each); cut only when /dev/shm cannot hold both with room to spare
FABRIC_SEGMENT_BYTES = 64 << 20


def scrape(port) -> list:
    """[(name, labels, value)] of a frontend's /metrics."""
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=60) as r:
        text = r.read().decode()
    out = []
    for line in text.splitlines():
        m = re.match(r"^([A-Za-z_:][\w:]*)(?:\{(.*)\})? (\S+)$", line)
        if m:
            labels = dict(re.findall(r'(\w+)="((?:[^"\\]|\\.)*)"',
                                     m.group(2) or ""))
            out.append((m.group(1), labels, float(m.group(3))))
    return out


def metric(samples, name, **labels) -> float:
    """The sum of a family's series whose labels include `labels`."""
    return sum(v for n, got, v in samples if n == name and all(
        got.get(k) == w for k, w in labels.items()))


SHM_EVENTS = "greptimedb_tpu_shm_fabric_events_total"
DISPATCH = "greptimedb_tpu_pallas_dispatch_total"


def fabric_events(samples) -> dict:
    """{kind: {event: count}} of the shm fabric's events."""
    out: dict = {}
    for n, labels, v in samples:
        if n == SHM_EVENTS:
            out.setdefault(labels.get("kind"), {})[labels.get("event")] = v
    return out


def kernel_launches(samples) -> dict:
    return {"segment_sum": int(metric(samples, DISPATCH,
                                      kernel="segment_sum")),
            "fused_segment_agg": int(metric(samples, DISPATCH,
                                            kernel="fused_agg"))}


def descendants(pid: int) -> set:
    """Every live process under `pid` (from /proc)."""
    children: dict = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
        except (OSError, ValueError, IndexError):
            continue
        children.setdefault(ppid, []).append(int(entry))
    out, todo = set(), [pid]
    while todo:
        for c in children.get(todo.pop(), []):
            if c not in out:
                out.add(c)
                todo.append(c)
    return out


def proc_line(pid: int) -> str:
    """A process's pid, state, parent, threads and command line, for a
    message (what /proc lets this process read)."""
    def read(name):
        try:
            with open(f"/proc/{pid}/{name}", "rb") as f:
                return f.read().replace(b"\0", b" ").decode(
                    errors="replace").strip()
        except OSError as e:
            return f"?{e.errno}"

    stat = read("stat").rsplit(")", 1)[-1].split()
    try:
        threads = len(os.listdir(f"/proc/{pid}/task"))
    except OSError:
        threads = "?"
    return f"{pid} {stat[:2]} threads={threads} {read('cmdline')[:160]}"


def alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


class Frontend:
    """One `standalone start -c <toml>` subprocess over its own data dir:
    HTTP, MySQL and Postgres on free ports; with a `process_mode`,
    batching off (every statement runs alone, so bodies compare) and that
    encode process mode, else the concurrency plane's defaults; the shm
    fabric when `fabric_dir` is given; `extra` TOML appended. Its stderr
    goes to a file beside its config."""

    def __init__(self, name, root, cfg_dir, env, process_mode=None,
                 fabric_dir=None, segment_bytes=FABRIC_SEGMENT_BYTES,
                 extra="", flight=False):
        self.name = name
        self.flight = flight
        cfg = os.path.join(cfg_dir, f"{name}.toml")
        text = (f"[storage]\ndata_home = '{root}'\n"
                "[http]\naddr = '127.0.0.1:0'\n"
                "[mysql]\nenable = true\naddr = '127.0.0.1:0'\n"
                "[postgres]\nenable = true\naddr = '127.0.0.1:0'\n"
                + extra)
        if flight:
            text += "[grpc]\nenable = true\naddr = '127.0.0.1:0'\n"
        if process_mode is not None:
            text += ("[concurrency]\nbatching = false\n"
                     f"encode_process_mode = '{process_mode}'\n")
        if fabric_dir is not None:
            text += (f"[shm]\nfabric = true\nfabric_dir = '{fabric_dir}'\n"
                     f"fabric_bytes = {segment_bytes}\n")
        with open(cfg, "w") as f:
            f.write(text)
        cmd = [sys.executable, "-m", "greptimedb_tpu_torch", "standalone",
               "start", "-c", cfg]
        if DEVICE is not None:
            cmd += ["--device", DEVICE]
        self.err_path = os.path.join(cfg_dir, f"{name}.stderr")
        self.err = open(self.err_path, "w")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(cmd, cwd=HERE, env=env,
                                     stdout=subprocess.PIPE,
                                     stderr=self.err, bufsize=0)

    def wait_ready(self) -> None:
        """The listening lines: HTTP, Flight (when enabled), MySQL and
        Postgres ports."""
        lines = read_ready(self.proc, 4 if self.flight else 3)
        if self.flight:
            flight_line = lines.pop(1)
            check(flight_line.startswith("flight on grpc://127.0.0.1:"),
                  f"frontend {self.name}: no Flight line: {flight_line!r} "
                  f"{self.stderr_tail()}")
            self.flight_port = int(flight_line.rsplit(":", 1)[1])
        check("listening on http://127.0.0.1:" in lines[0]
              and lines[1].startswith("mysql on 127.0.0.1:")
              and lines[2].startswith("postgres on 127.0.0.1:"),
              f"frontend {self.name} did not start: {lines!r} "
              f"{self.stderr_tail()}")
        self.start_s = time.perf_counter() - self.t0
        self.port, self.my_port, self.pg_port = (
            int(x.rsplit(":", 1)[1]) for x in lines)

    def stderr_tail(self) -> str:
        self.err.flush()
        with open(self.err_path) as f:
            return f.read()[-2000:]

    def sql(self, sql) -> tuple:
        """(ms, body without execution_time_ms) of one POST /v1/sql."""
        import urllib.parse
        import urllib.request

        data = urllib.parse.urlencode({"sql": sql}).encode()
        t = time.perf_counter()
        req = urllib.request.Request(
            f"http://127.0.0.1:{self.port}/v1/sql", data=data)
        with urllib.request.urlopen(req, timeout=300) as r:
            body = r.read()
            check(r.status == 200, f"{self.name}: {sql}: {r.status}")
        return (time.perf_counter() - t) * 1000, strip_time(body)

    def metrics(self) -> list:
        return scrape(self.port)

    def stop(self) -> int:
        import signal

        self.proc.send_signal(signal.SIGTERM)
        rc = self.proc.wait(timeout=120)
        check(rc == 0, f"frontend {self.name} exited {rc}: "
              f"{self.stderr_tail()}")
        return rc

    def close(self) -> None:
        """Kill what is left of it (after a failed check): the frontend
        and every process under it."""
        import signal

        if self.proc.poll() is None:
            for pid in descendants(self.proc.pid):
                try:
                    os.kill(pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
            self.proc.kill()
            self.proc.wait()
        self.proc.stdout.close()
        self.err.close()


def same_answer(got: bytes, want: bytes) -> float:
    """0.0 when two /v1/sql bodies are byte for byte equal, else the
    largest relative difference of a cell in an average column
    (`avg(...)`) when everything else (schema, row count, every other
    cell) is equal; raises CheckFailed otherwise. On the card K1 and K2
    add f32 values with atomics in no fixed order, so two runs of one
    average may differ in the last bits; the fabric-off control D of
    fabric_phase measures how often two processes' bodies do."""
    if got == want:
        return 0.0
    a, b = (json.loads(x + b"}")["output"] for x in (got, want))
    check(len(a) == len(b), "bodies: statement counts differ")
    worst = 0.0
    for ra, rb in zip(a, b):
        check(ra.keys() == rb.keys() and "records" in ra,
              f"bodies differ: {got[:200]!r} / {want[:200]!r}")
        ra, rb = ra["records"], rb["records"]
        check(ra["schema"] == rb["schema"]
              and len(ra["rows"]) == len(rb["rows"]),
              "bodies: schema or row count differ")
        avg = [c["name"].startswith("avg(")
               for c in ra["schema"]["column_schemas"]]
        for x, y in zip(ra["rows"], rb["rows"]):
            for is_avg, u, v in zip(avg, x, y):
                if is_avg and isinstance(u, float) and isinstance(v, float):
                    worst = max(worst, abs(u - v) / max(abs(v), 1e-300))
                else:
                    check(u == v, f"bodies: cell {u!r} != {v!r}")
    return worst


def shifted(tenants, offset: int) -> list:
    """The same tenants' statements with other parameters."""
    return [(name, (lambda g: lambda i: g(i + offset))(gen))
            for name, gen in tenants]


def shm_segment_bytes() -> tuple:
    """(bytes a segment, the /dev/shm figures): the JAX default where
    /dev/shm holds both segments three times over, else a third of what
    is free each (the cut is printed)."""
    st = os.statvfs("/dev/shm")
    free, total = st.f_bavail * st.f_frsize, st.f_blocks * st.f_frsize
    size = FABRIC_SEGMENT_BYTES
    if free < 6 * size:
        size = max(1 << 20, free // 6)
    shm = {"total_bytes": total, "free_bytes": free,
           "segment_bytes": size, "cut": size != FABRIC_SEGMENT_BYTES}
    log("fabric: /dev/shm " + json.dumps(shm))
    return size, shm


def fabric_phase(root, grid) -> dict:
    """(i) two frontends on one shm fabric over copies of the closed
    cpu_1h dir, beside a fabric-off frontend C over the original and a
    fabric-off control D over a third copy: A's mixed round publishes
    templates and plans, B's first sightings adopt them (hits above 0),
    every body of A, B and D equals C's byte for byte but in the average
    columns, held to rtol 1e-5 (MySQL and Postgres rows equal), with the
    bodies that differ counted for each, a 100,000-row result goes through the
    arena with the bridged encode count exact, A's DDL makes B miss A's
    published template, B is SIGKILLed while serving and A answers on,
    and afterwards no segment, no child process and no detach or corrupt
    event is left. K1 and K2 launch in both A and B."""
    import shutil
    import signal
    import tempfile
    import threading

    from greptimedb_tpu_torch.shm.fabric import segment_name

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_fabric_")
    fabric_dir = os.path.join(work, "fabric")
    segments = [segment_name(fabric_dir),
                segment_name(os.path.join(fabric_dir, "arena"))]
    seg_bytes, shm_info = shm_segment_bytes()
    env = {k: v for k, v in os.environ.items()
           if k not in LANE_OFF and not k.startswith("GTPU_SHM_")}
    env["PYTHONPATH"] = HERE
    for name in ("a", "b", "d"):
        clone_data_dir(root, os.path.join(work, name))
    fronts = {}
    out: dict = {"shm": shm_info}
    try:
        fronts["C"] = Frontend("C", root, work, env, "off")
        fronts["A"] = Frontend("A", os.path.join(work, "a"), work, env,
                               "on", fabric_dir, seg_bytes)
        fronts["B"] = Frontend("B", os.path.join(work, "b"), work, env,
                               "on", fabric_dir, seg_bytes)
        fronts["D"] = Frontend("D", os.path.join(work, "d"), work, env,
                               "off")
        for f in fronts.values():
            f.wait_ready()
        A, B, C, D = (fronts[k] for k in "ABCD")
        out["start_s"] = {k: f.start_s for k, f in fronts.items()}
        log("fabric: frontends listening after (s) "
            + json.dumps(out["start_s"]))
        tenants = mixed_tenants(SERVE_HOURS)
        queries = tsbs_queries()
        dgb = queries["double_groupby_all"][0].replace(
            f"ts < {T0_MS + HOURS * 3600 * 1000}",
            f"ts < {T0_MS + SERVE_HOURS * 3600 * 1000}")
        # the headline at a 10-minute bucket: G + 1 = HOSTS x 6 + 1 groups
        # pass the fused kernel's 4,096, so K1 serves it
        dgb_10m = dgb.replace("INTERVAL '1 hour'", "INTERVAL '10 minutes'")
        bodies: dict = {}

        def keep(who, sql, body):
            bodies.setdefault(sql, {}).setdefault(who, set()).add(body)

        # 1. A's round learns and publishes; B's first sightings adopt
        rounds = {}
        for sql in (dgb, dgb_10m):
            keep("A", sql, A.sql(sql)[1])
        rounds["A"] = drive(A.port, tenants, FABRIC_CLIENTS,
                            FABRIC_REQUESTS)
        b_tenants = shifted(tenants, FABRIC_OFFSET)
        firsts = {"B": {}, "C": {}}
        for who in ("B", "C"):
            for name, gen in b_tenants:
                ms, body = fronts[who].sql(gen(0))
                firsts[who][name] = ms
                keep(who, gen(0), body)
            for sql in (dgb, dgb_10m):
                ms, body = fronts[who].sql(sql)
                firsts[who][sql[:40]] = ms
                keep(who, sql, body)
        ev_b_first = fabric_events(B.metrics())
        for who in ("B", "C"):
            rounds[who] = drive(fronts[who].port, b_tenants, FABRIC_CLIENTS,
                                FABRIC_REQUESTS)
        for who, r in rounds.items():
            check(sum(r["errors"].values()) == 0,
                  f"fabric: {who}'s round had errors {r['first_error']}")
            for sql, got in r["bodies"].items():
                for b in got:
                    keep(who, sql, b)
        ev_a, ev_b = fabric_events(A.metrics()), fabric_events(B.metrics())
        tpl_b, plan_b = ev_b.get("template", {}), ev_b.get("plan", {})
        check(tpl_b.get("hit", 0) > 0 and plan_b.get("hit", 0) > 0,
              f"fabric: B adopted nothing from A ({ev_b})")
        check(ev_a.get("template", {}).get("publish", 0) > 0
              and ev_a.get("plan", {}).get("publish", 0) > 0,
              f"fabric: A published nothing ({ev_a})")
        out["events_after_rounds"] = {"A": ev_a, "B": ev_b,
                                      "B_after_first_sightings": ev_b_first}
        out["first_sighting_ms"] = firsts
        out["rounds"] = {who: {"requests": r["requests"],
                               "wall_s": r["wall_s"],
                               "qps": r["requests"] / r["wall_s"]}
                         for who, r in rounds.items()}
        log("fabric: B's templates " + json.dumps(tpl_b) + ", plans "
            + json.dumps(plan_b) + "; first sightings ms (B fabric on, C "
            "off) " + json.dumps(firsts) + "; rounds "
            + json.dumps(out["rounds"]))
        # 2. every body against the fabric-off frontend C's: byte for
        # byte but in f32 average columns (rtol 1e-5, see same_answer).
        # D, fabric off too, runs each statement once: the control for
        # how often two processes' averages differ without the fabric
        for sql, by in bodies.items():
            if "C" not in by:
                by["C"] = {C.sql(sql)[1]}
            by["D"] = {D.sql(sql)[1]}
        cmp = {who: {"bodies": 0, "byte_identical": 0, "differing_rel": []}
               for who in "ABCD"}
        for sql, by in bodies.items():
            want = next(iter(by["C"]))
            for who in "ABCD":
                for body in by.get(who, ()):
                    rel = same_answer(body, want)
                    check(rel <= 1e-5, f"fabric: {who}'s body for {sql} "
                          f"differs from the fabric-off body by {rel}")
                    c = cmp[who]
                    c["bodies"] += 1
                    if rel:
                        c["differing_rel"].append(rel)
                    else:
                        c["byte_identical"] += 1
        for c in cmp.values():
            c["differing_rel"].sort()
        # each statement's first body of C is the reference, not a
        # reading: C's row counts only its other bodies (repeats in its
        # round that came out otherwise)
        cmp["C"]["bodies"] -= len(bodies)
        cmp["C"]["byte_identical"] -= len(bodies)
        wire = []
        for sql in (tenants[0][1](3), tenants[1][1](5)):
            got = []
            for f in (A, B, C):
                my = WireMysql(f.my_port)
                pg = WirePg(f.pg_port)
                try:
                    got.append((my.query(sql), pg.query(sql)))
                finally:
                    my.close()
                    pg.close()
            check(got[0] == got[2] and got[1] == got[2],
                  f"fabric: MySQL / Postgres rows for {sql} differ")
            wire.append(got[2][0][2])
        out["bodies"] = {"statements": len(bodies), "by_frontend": cmp}
        log(f"fabric: bodies over {len(bodies)} statements against C's "
            "(A, B fabric on; C's own repeats; D fabric off, the control): "
            + json.dumps(cmp) + f"; MySQL and Postgres rows equal for "
            f"{len(wire)} statements")
        # 3. a large result through the arena, the bridged count exact
        steps = -(-FABRIC_BIG_ROWS // HOSTS)
        big = (f"SELECT hostname, ts, usage_user FROM cpu WHERE ts < "
               f"{T0_MS + steps * STEP_S * 1000} ORDER BY hostname, ts")
        before = A.metrics()
        ms_a, body_a = A.sql(big)
        after = A.metrics()
        ms_c, body_c = C.sql(big)
        rows = len(json.loads(body_c + b"}")["output"][0]["records"]["rows"])
        res_before = fabric_events(before).get("result", {})
        res_after = fabric_events(after).get("result", {})
        enc = metric(after, "greptimedb_tpu_encode_seconds_count",
                     protocol="process")
        offloads = metric(after, "greptimedb_tpu_encode_pool_events_total",
                          event="offload_process")
        arena = {"rows": rows, "bytes": len(body_a), "ms_A_arena": ms_a,
                 "ms_C_thread": ms_c,
                 "publish": res_after.get("publish", 0)
                 - res_before.get("publish", 0),
                 "claim": res_after.get("hit", 0) - res_before.get("hit", 0),
                 "process_encodes_bridged": enc,
                 "process_offloads": offloads,
                 "arena_bytes": metric(after,
                                       "greptimedb_tpu_shm_fabric_bytes",
                                       segment="arena", dim="size")}
        log("fabric: arena " + json.dumps(arena))
        check(rows >= FABRIC_BIG_ROWS and body_a == body_c,
              f"fabric: the {rows}-row result differs from the thread "
              "encode")
        check(arena["publish"] == 1 and arena["claim"] == 1,
              f"fabric: the large result did not ride the arena {arena}")
        check(enc == offloads and enc > 0,
              f"fabric: bridged process encodes {enc} != offloads "
              f"{offloads}: " + json.dumps(
                  [x for x in after if "encode" in x[0]]))
        out["arena"] = arena
        # 4. a peer's DDL reaches the other frontend
        hour = T0_MS + 3600 * 1000

        def shape2(h, lo):
            return (f"SELECT max(usage_idle), min(usage_nice) FROM cpu WHERE "
                    f"hostname = 'host_{h}' AND ts >= {lo} AND "
                    f"ts < {hour}")

        pub0 = fabric_events(A.metrics()).get("template", {})
        for _ in range(2):
            A.sql(shape2(1, T0_MS))
        pub1 = fabric_events(A.metrics()).get("template", {})
        check(pub1.get("publish", 0) == pub0.get("publish", 0) + 1,
              f"fabric: A did not publish the DDL probe's template "
              f"({pub0} -> {pub1})")
        A.sql("ALTER TABLE cpu ADD COLUMN extra DOUBLE")
        ev0 = fabric_events(B.metrics())
        lo_b = T0_MS + 600 * 1000
        _, body = B.sql(shape2(7, lo_b))
        ev1 = fabric_events(B.metrics())
        row = json.loads(body + b"}")["output"][0]["records"]["rows"][0]
        p0 = (lo_b - T0_MS) // (STEP_S * 1000)
        want = (grid["usage_idle"][p0:, 7].max(),
                grid["usage_nice"][p0:, 7].min())
        check(all(g in (w, float(f32_exact(np.float64(w))))
                  for g, w in zip(row, want)),
              f"fabric: B's rows after A's DDL {row} != numpy {want}")

        def delta(kind, event):
            return ev1.get(kind, {}).get(event, 0) \
                - ev0.get(kind, {}).get(event, 0)

        ddl = {"template_miss": delta("template", "miss"),
               "template_hit": delta("template", "hit"),
               "plan_miss": delta("plan", "miss"),
               "plan_hit": delta("plan", "hit"),
               "A_invalidates": fabric_events(A.metrics()).get(
                   "fabric", {}).get("invalidate", 0)}
        log("fabric: after A's ALTER, B's first sighting " + json.dumps(ddl))
        check(ddl["template_miss"] == 1 and ddl["template_hit"] == 0
              and ddl["plan_hit"] == 0 and ddl["A_invalidates"] >= 1,
              f"fabric: A's DDL did not reach B {ddl}")
        out["ddl"] = ddl
        # 5. K1 and K2 in both fabric frontends, then B dies serving
        samples_b = B.metrics()
        launches = {"A": kernel_launches(A.metrics()),
                    "B": kernel_launches(samples_b)}
        bad = {"B": fabric_events(samples_b)}
        kids_b = descendants(B.proc.pid)
        log("fabric: B's processes before the kill: "
            + "; ".join(proc_line(p) for p in sorted(kids_b)))
        stop = threading.Event()
        served = {"ok": 0, "failed": 0}

        def hammer():
            gen = b_tenants[0][1]
            i = 0
            while not stop.is_set():
                try:
                    B.sql(gen(i))
                    served["ok"] += 1
                except Exception:  # noqa: BLE001 — B is being killed
                    served["failed"] += 1
                    return
                i += 1

        th = threading.Thread(target=hammer)
        th.start()
        time.sleep(0.5)
        B.proc.send_signal(signal.SIGKILL)
        B.proc.wait(timeout=60)
        stop.set()
        th.join(timeout=60)
        check(not th.is_alive(), "fabric: the client of B did not stop")
        after_kill = []
        for i in range(5):
            sql = tenants[0][1](100 + i)
            after_kill.append(A.sql(sql)[1] == C.sql(sql)[1])
        check(all(after_kill), "fabric: A's bodies after B's SIGKILL differ")
        # B's encode workers exit on their own once their parent is gone
        # (a 5 s watchdog): they hold attach flocks, so wait for them
        deadline = time.perf_counter() + 30
        while any(alive(p) for p in kids_b) \
                and time.perf_counter() < deadline:
            time.sleep(0.5)
        check(not any(alive(p) for p in kids_b),
              "fabric: B's children outlived it: "
              + "; ".join(proc_line(p) for p in sorted(kids_b)))
        samples_a = A.metrics()
        bad["A"] = fabric_events(samples_a)
        for who, ev in bad.items():
            n = sum(e.get(k, 0) for e in ev.values()
                    for k in ("detach", "corrupt"))
            check(n == 0, f"fabric: {who} counted detach or corrupt {ev}")
        kids = set()
        for f in (A, C, D):
            kids |= descendants(f.proc.pid) | {f.proc.pid}
        out["stop_rc"] = {"A": A.stop(), "C": C.stop(), "D": D.stop()}
        left = [n for n in segments if os.path.exists("/dev/shm/" + n)]
        check(left == [], f"fabric: segments left in /dev/shm: {left}")
        # a stopped frontend's helpers (its resource tracker) see its
        # pipe close and exit just after it
        deadline = time.perf_counter() + 20
        while any(alive(p) for p in kids) \
                and time.perf_counter() < deadline:
            time.sleep(0.2)
        check(not any(alive(p) for p in kids | kids_b),
              "fabric: a frontend's process outlived it: " + "; ".join(
                  proc_line(p) for p in sorted(kids | kids_b) if alive(p)))
        if DEVICE is None:
            for who, k in launches.items():
                check(k["segment_sum"] > 0 and k["fused_segment_agg"] > 0,
                      f"fabric: frontend {who} launched {k}")
        out["launches"] = launches
        out["sigkill"] = {"B_served_before_kill": served["ok"],
                          "A_bodies_after_kill": len(after_kill),
                          "B_children_reaped": len(kids_b)}
        log("fabric: K1/K2 launches by frontend " + json.dumps(launches)
            + "; SIGKILL " + json.dumps(out["sigkill"]))
    except CheckFailed:
        for f in fronts.values():
            log(f"fabric frontend {f.name} stderr: {f.stderr_tail()}")
        raise
    finally:
        for f in fronts.values():
            f.close()
        for n in segments:
            if os.path.exists("/dev/shm/" + n):
                os.unlink("/dev/shm/" + n)
        shutil.rmtree(work, ignore_errors=True)
    out["k1_launches"] = sum(k["segment_sum"]
                             for k in out["launches"].values())
    out["k2_launches"] = sum(k["fused_segment_agg"]
                             for k in out["launches"].values())
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"serving fabric (cpu_1h, 2 frontends): {out['phase_s']:.1f} s")
    return out


# ---- (h) flows, parallel decode, scripts and plugins ---------------------------

#: the continuous aggregate: the headline's hostname x hour groups, the
#: ten fields' averages, the peak usage_user and the rows a group
FLOW_SQL = ("CREATE FLOW cpu_hourly SINK TO cpu_hourly_sink AS SELECT "
            "hostname, date_bin(INTERVAL '1 hour', ts) AS hour, "
            + ", ".join(f"avg({f})" for f in FIELDS)
            + ", max(usage_user), count(*) FROM cpu GROUP BY hostname, hour")
#: the sink's visible columns (the flow engine's identifiers of the
#: query's output names)
FLOW_COLS = [f"avg_{f}_" for f in FIELDS] + ["max_usage_user_", "count___"]
#: a dirty-span flow: median has no mergeable state
P50_HOSTS = 8
P50_SQL = ("CREATE FLOW cpu_p50 SINK TO cpu_p50_sink AS SELECT hostname, "
           "median(usage_user) AS p50 FROM cpu WHERE hostname IN ("
           + ", ".join(f"'host_{i}'" for i in range(P50_HOSTS))
           + ") GROUP BY hostname")
FLOW_SEED = 41
#: the coprocessor: per-host sums of the first ten minutes on the
#: engine's device, run in the sandbox worker
SCRIPT_MINUTES = 10


def clone_data_dir(src: str, dst: str) -> None:
    """A copy of a closed data dir that the copy's engine may write:
    SSTs and their puffin indexes (immutable once written) as hard links,
    WAL segments, manifests and the catalog as bytes."""
    import shutil

    def copy(s, d):
        if s.endswith((".sst", ".puffin")):
            try:
                os.link(s, d)
                return d
            except OSError:
                pass
        return shutil.copy2(s, d)

    shutil.copytree(src, dst, copy_function=copy)


def clear_region_caches(region) -> None:
    with region._lock:
        region._scan_cache_clear()
        region._part_cache.clear()
        region._part_cache_bytes = 0


def decode_phase(engine, rid, state: str) -> dict:
    """A cold Region.scan of `cpu` (every cache dropped) with one decode
    worker and with the engine's auto count: byte for byte the same
    columns; workers, wall ms, the objectstore_read spans and
    SCAN_DECODE_BYTES of each. The region's caches are dropped again
    after it, so the next query still starts cold."""
    from greptimedb_tpu_torch.utils import tracing
    from greptimedb_tpu_torch.utils.metrics import SCAN_DECODE_BYTES

    region = engine.region(rid)
    scans, out = {}, {}
    for label, threads in (("1", 1), ("auto", 0)):
        region.decode_threads = threads
        clear_region_caches(region)
        b0 = SCAN_DECODE_BYTES.get()
        with tracing.collect_spans() as spans:
            t = time.perf_counter()
            scan = engine.scan(rid)
            ms = (time.perf_counter() - t) * 1e3
        reads = [s for s in spans if s.name == "objectstore_read"]
        scans[label] = scan
        out[label] = {"ms": ms, "rows": scan.num_rows,
                      "workers": scan.stats["decode_workers"],
                      "files_decoded": scan.stats["files_decoded"],
                      "decode_bytes": SCAN_DECODE_BYTES.get() - b0,
                      "objectstore_reads": len(reads),
                      "objectstore_read_ms": sum(s.duration_ms
                                                 for s in reads)}
    a, b = scans["1"], scans["auto"]
    same = (a.num_rows == b.num_rows
            and a.sorted_part_offsets == b.sorted_part_offsets
            and set(a.columns) == set(b.columns)
            and all(a.columns[k].dtype == b.columns[k].dtype
                    and np.array_equal(a.columns[k], b.columns[k])
                    for k in a.columns)
            and np.array_equal(a.seq, b.seq)
            and np.array_equal(a.op_type, b.op_type))
    out["byte_for_byte"] = same
    out["speedup"] = out["1"]["ms"] / out["auto"]["ms"]
    out["ssts"] = len(region.files)
    del scans, a, b
    clear_region_caches(region)
    log(f"parallel decode (cold Region.scan of cpu, {state}): "
        + json.dumps(out))
    check(same, "parallel decode: the auto-worker scan differs from the "
          "one-worker scan")
    check(out["1"]["workers"] == 1 and (out["auto"]["workers"] > 1
                                        or (os.cpu_count() or 1) == 1),
          f"parallel decode: workers {out['1']['workers']} / "
          f"{out['auto']['workers']}")
    region.decode_threads = engine.config.scan_decode_threads
    return out


def hourly_oracle(fields: dict) -> dict:
    """float64 numpy over [points, hosts] per field: the avg of each field,
    max(usage_user) and the rows of each (hour, host)."""
    points = len(fields[FIELDS[0]])
    per_hour = 3600 // STEP_S
    starts = np.arange(0, points, per_hour)
    counts = np.diff(np.append(starts, points))
    out = {f"avg_{f}_": np.add.reduceat(fields[f], starts, axis=0)
           / counts[:, None] for f in FIELDS}
    out["max_usage_user_"] = np.maximum.reduceat(fields["usage_user"], starts,
                                                 axis=0)
    out["count___"] = np.repeat(counts[:, None], HOSTS, axis=1)
    return out


def sink_grid(res, hours: int) -> dict:
    """A result of (hostname, hour, FLOW_COLS...) rows as [hours, hosts]
    arrays; every (hour, host) must appear once."""
    cols = dict(zip(res.names, res.columns))
    h = host_index(np.asarray(cols["hostname"]))
    t = (np.asarray(cols["hour"], dtype=np.int64) - T0_MS) // 3_600_000
    check(res.num_rows == hours * HOSTS and len(set(zip(h.tolist(),
                                                         t.tolist())))
          == res.num_rows, f"flow sink: {res.num_rows} rows for "
          f"{hours} x {HOSTS} groups")
    out = {}
    for c in FLOW_COLS:
        g = np.full((hours, HOSTS), np.nan)
        g[t, h] = np.asarray(cols[c], dtype=np.float64)
        out[c] = g
    return out


def check_sink(got: dict, want: dict, rtol: float, what: str) -> float:
    worst = 0.0
    for c in FLOW_COLS:
        g, w = got[c], want[c]
        if c == "count___":
            check(np.array_equal(g, w), f"{what}: {c} differs")
            continue
        err = float(np.max(np.abs(g - w) / np.maximum(np.abs(w), 1e-300)))
        worst = max(worst, err)
        check(np.allclose(g, w, rtol=rtol, atol=0), f"{what}: {c} off by "
              f"{err:.3g} (rtol {rtol})")
    return worst


def flush_flow(qe, sk, name: str, torch) -> dict:
    """ADMIN flush_flow with its launches and the tick's stats."""
    from greptimedb_tpu_torch.flow import FlowEngine

    FlowEngine.last_tick_stats = None
    zero_launches(sk)
    sync(torch)
    t = time.perf_counter()
    n = qe.execute_one(f"ADMIN flush_flow('{name}')").affected_rows
    sync(torch)
    k = launches(sk)
    return {"ms": (time.perf_counter() - t) * 1e3, "rows_upserted": n,
            "k1_launches": k[0], "k2_launches": k[1],
            "tick": FlowEngine.last_tick_stats}


def read_sink(qe):
    cols = ", ".join(["hostname", "hour"] + FLOW_COLS)
    return qe.execute_one(f"SELECT {cols} FROM cpu_hourly_sink")


def script_plugin_phase(qe, sk, torch, fields) -> dict:
    """A coprocessor saved through /v1/scripts and run through
    /v1/run-script (torch on the engine's device in the sandbox worker)
    against numpy; a scalar-function plugin in the headline's WHERE
    against the plain query; an interceptor counted once a statement on
    the fast lane and on the slow lane."""
    import urllib.request

    from greptimedb_tpu_torch.servers import HttpServer

    out = {}
    lo, hi = T0_MS, T0_MS + SCRIPT_MINUTES * 60_000
    code = f'''
@coprocessor(args=["hostname", "usage_user"],
             returns=["host", "total", "n", "on_device"],
             sql="SELECT hostname, usage_user FROM cpu WHERE ts >= {lo} "
                 "AND ts < {hi}")
def per_host(hostname, usage_user):
    import torch
    names, inv = np.unique(np.asarray(hostname, dtype=str),
                           return_inverse=True)
    ids = torch.as_tensor(inv.reshape(-1).astype(np.int64), device=device)
    u = torch.as_tensor(np.asarray(usage_user, dtype=np.float64),
                        device=device)
    total = torch.zeros(len(names), dtype=torch.float64,
                        device=device).index_add_(0, ids, u)
    n = torch.zeros(len(names), dtype=torch.int64,
                    device=device).index_add_(0, ids, torch.ones_like(ids))
    where = u.device.type == torch.device(device).type
    return names, total, n, np.asarray([where] * len(names))
'''
    srv = HttpServer(qe, port=0)
    port = srv.start()
    try:
        def post(path, body=b""):
            req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                         data=body, method="POST")
            with urllib.request.urlopen(req, timeout=300) as r:
                return json.loads(r.read())

        zero_launches(sk)
        t = time.perf_counter()
        saved = post("/v1/scripts?db=public&name=per_host", code.encode())
        save_ms = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        doc = post("/v1/run-script?db=public&name=per_host")
        run_ms = (time.perf_counter() - t) * 1e3
        k = launches(sk)
        worker = qe._script_engine._worker[0]
    finally:
        srv.stop()
    worker.wait(30)
    check(saved.get("code") == 0 and doc.get("code") == 0,
          f"script: {saved} / {str(doc)[:300]}")
    rows = doc["output"][0]["records"]["rows"]
    points = SCRIPT_MINUTES * 60 // STEP_S
    want = fields["usage_user"][:points].sum(axis=0)
    got = np.full(HOSTS, np.nan)
    n = np.zeros(HOSTS, dtype=np.int64)
    hosts = host_index(np.asarray([r[0] for r in rows], dtype=object))
    got[hosts] = [r[1] for r in rows]
    n[hosts] = [r[2] for r in rows]
    check(len(rows) == HOSTS and np.all(n == points)
          and np.allclose(got, want, rtol=1e-12, atol=0)
          and all(r[3] for r in rows),
          "script per_host: the coprocessor's sums differ from numpy or "
          "its tensors were not on the engine's device")
    check(worker.poll() is not None, "script: the sandbox worker outlived "
          "the server")
    out["script"] = {"save_ms": save_ms, "run_ms": run_ms, "rows": len(rows),
                     "k1_launches": k[0], "k2_launches": k[1],
                     "engine_device": str(qe.device)}
    log("script per_host (/v1/scripts, /v1/run-script): "
        + json.dumps(out["script"]))

    # a scalar-function plugin in the headline's WHERE
    sql = tsbs_queries()["double_groupby_all"][0]
    psql = sql.replace("WHERE ", "WHERE smoke_abs(usage_user) >= 0 AND ", 1)
    qe.plugins.register_scalar_function("smoke_abs", np.abs)
    try:
        with partial_cache(False):
            zero_launches(sk)
            res_p, ms_p = timed_query(qe, psql, torch)
            kp = launches(sk)
            path_p = qe.executor.last_path
            res, ms = timed_query(qe, sql, torch)
    finally:
        qe.plugins._scalar_functions.pop("smoke_abs", None)
    rows_agree(res, res_p, "plugin in the headline's WHERE")
    out["plugin"] = {"ms": ms_p, "plain_ms": ms, "last_path": path_p,
                     "rows": res_p.num_rows, "k1_launches": kp[0],
                     "k2_launches": kp[1]}
    log("plugin smoke_abs(usage_user) >= 0 in double_groupby_all: "
        + json.dumps(out["plugin"]))

    # the interceptor chain: once a statement, fast lane and slow lane
    calls = []

    def audit(text, ctx):
        calls.append(text)
        return text

    stmt = tsbs_queries()["single_groupby_1_1_1"][0]
    qe.plugins.register_sql_interceptor(audit)
    counts = {}
    try:
        zero_launches(sk)
        with defaults_plane(qe) as plane:
            for _ in range(4):  # mark, build, hit, hit
                qe.execute_one(stmt)
            counts["fast"] = len(calls)
            hits = len(plane.fast_lane)
        calls.clear()
        for _ in range(3):  # the engine's own plane: lane off here
            qe.execute_one(stmt)
        counts["slow"] = len(calls)
        k = launches(sk)
    finally:
        qe.plugins._sql_interceptors.remove(audit)
    check(counts == {"fast": 4, "slow": 3} and hits == 1,
          f"interceptor: {counts}, fast-lane templates {hits}")
    out["interceptor"] = {"counts": counts, "k1_launches": k[0],
                          "k2_launches": k[1]}
    log("interceptor chain (single_groupby_1_1_1): "
        + json.dumps(out["interceptor"]))
    return out


def flow_phase(root, sk, torch, grid) -> dict:
    """(h) on a copy of the main path's closed data dir (the write
    plane's phase reads the original): the cold parallel decode
    comparison; the hourly continuous aggregate of `cpu` (first fold, an
    appended hour in two halves around a flush, a restart); a dirty-span
    flow; the script and plugin checks."""
    import shutil

    from greptimedb_tpu_torch.datatypes import DictVector, RecordBatch
    from greptimedb_tpu_torch.utils.metrics import SCAN_DECODE_BYTES

    import threading

    from greptimedb_tpu_torch.storage.scan_pool import THREAD_PREFIX

    t_phase = time.perf_counter()
    threads_before = set(threading.enumerate())
    froot = root + "_flow"
    t = time.perf_counter()
    clone_data_dir(root, froot)
    out: dict = {"clone_s": time.perf_counter() - t}
    engine = None
    try:
        engine, qe = open_engine(froot)
        info = qe.catalog.table("public", "cpu")
        rid = info.region_ids[0]
        region = engine.open_region(rid)
        out["decode"] = decode_phase(engine, rid, "compacted: one SST")

        # the continuous aggregate
        zero_launches(sk)
        t = time.perf_counter()
        qe.execute_one(FLOW_SQL)
        k = launches(sk)
        out["create"] = {"ms": (time.perf_counter() - t) * 1e3,
                         "k1_launches": k[0], "k2_launches": k[1],
                         "incremental": qe.flow_engine.list_flows()[0]
                         .incremental}
        check(out["create"]["incremental"], "flow cpu_hourly: not on the "
              "incremental path")
        first = flush_flow(qe, sk, "cpu_hourly", torch)
        rows0 = region.num_sst_rows + region.memtable.num_rows
        out["first_fold"] = first
        log("flow cpu_hourly first fold: " + json.dumps(first))
        check(first["tick"]["path"] == "incremental"
              and first["tick"]["scanned_rows"] == rows0
              and first["k2_launches"] == 1 and first["k1_launches"] == 0,
              f"flow first fold: {first}")

        # one more hour for every host, in two halves around a flush
        rng = np.random.default_rng(FLOW_SEED)
        names = np.asarray([f"host_{i}" for i in range(HOSTS)], dtype=object)
        p0 = len(grid[FIELDS[0]])
        per_hour = 3600 // STEP_S
        new = {f: [] for f in FIELDS}
        half = per_hour // 2
        for a, b in ((p0, p0 + half), (p0 + half, p0 + per_hour)):
            put_points(engine, info, rng, a, b, names, new)
            if a == p0:
                qe.execute_one("ADMIN flush_table('cpu')")
        fields = {f: np.concatenate([grid[f]] + [x.reshape(-1, HOSTS)
                                                 for x in new[f]])
                  for f in FIELDS}
        b0 = SCAN_DECODE_BYTES.get()
        tick = flush_flow(qe, sk, "cpu_hourly", torch)
        tick["decode_bytes"] = SCAN_DECODE_BYTES.get() - b0
        out["appended_hour"] = tick
        log("flow cpu_hourly tick after one more hour: " + json.dumps(tick))
        check(tick["tick"]["scanned_rows"] == HOSTS * per_hour
              and tick["k2_launches"] == 1 and tick["k1_launches"] == 0
              and tick["tick"]["ssts_seq_pruned"] >= 1
              and tick["tick"]["files_decoded"] == 1,
              f"flow tick: {tick} (the old SSTs must stay on disk)")

        # the sink against numpy over every hour, and the direct SQL
        hours = -(-len(fields[FIELDS[0]]) // per_hour)
        want = hourly_oracle(fields)
        t = time.perf_counter()
        sink = sink_grid(read_sink(qe), hours)
        read_ms = (time.perf_counter() - t) * 1e3
        out["oracle_max_rel_err"] = check_sink(sink, want, 1e-9,
                                               "flow sink vs numpy")
        direct_sql = FLOW_SQL.split(" AS ", 1)[1]
        with partial_cache(False):
            zero_launches(sk)
            direct, direct_ms = timed_query(qe, direct_sql, torch)
            kd = launches(sk)
        dcols = dict(zip(direct.names, direct.columns))
        renamed = dict(zip(["hostname", "hour"] + FLOW_COLS,
                           [dcols[n] for n in direct.names]))
        dres = type("R", (), {"names": list(renamed),
                              "columns": list(renamed.values()),
                              "num_rows": direct.num_rows})
        out["direct_max_rel_err"] = check_sink(
            sink, sink_grid(dres, hours), 1e-5, "flow sink vs direct SQL")
        out["direct"] = {"ms": direct_ms, "k1_launches": kd[0],
                         "k2_launches": kd[1],
                         "last_path": qe.executor.last_path}
        out["sink_read_ms"] = read_ms
        log("flow cpu_hourly sink: " + json.dumps({
            "groups": hours * HOSTS, "oracle_max_rel_err":
            out["oracle_max_rel_err"], "direct_max_rel_err":
            out["direct_max_rel_err"], "direct": out["direct"],
            "sink_read_ms": read_ms}))

        # a restart: the tick folds nothing and leaves the sink as it was
        engine.close()
        engine = None
        engine, qe = open_engine(froot)
        engine.open_region(rid)
        again = flush_flow(qe, sk, "cpu_hourly", torch)
        out["after_restart"] = again
        after = sink_grid(read_sink(qe), hours)
        log("flow cpu_hourly after a restart: " + json.dumps(again))
        check(again["rows_upserted"] == 0 and again["k1_launches"] == 0
              and again["k2_launches"] == 0
              and again["tick"]["scanned_rows"] == 0
              and all(np.array_equal(after[c], sink[c], equal_nan=True)
                      for c in FLOW_COLS),
              f"flow after a restart: {again}")

        # a dirty-span flow (median is not decomposable)
        zero_launches(sk)
        t = time.perf_counter()
        qe.execute_one(P50_SQL)
        create_ms = (time.perf_counter() - t) * 1e3
        p50 = flush_flow(qe, sk, "cpu_p50", torch)
        p50["create_ms"] = create_ms
        got = qe.execute_one("SELECT hostname, p50 FROM cpu_p50_sink")
        h = host_index(np.asarray(got.columns[0]))
        want_p50 = np.median(fields["usage_user"][:, :P50_HOSTS], axis=0)
        check(p50["tick"]["path"] == "dirty_span" and got.num_rows
              == P50_HOSTS and np.allclose(np.asarray(got.columns[1],
                                                      dtype=float),
                                           want_p50[h], rtol=1e-12, atol=0),
              f"flow cpu_p50: {p50}")
        out["dirty_span"] = p50
        log("flow cpu_p50 (dirty span): " + json.dumps(p50))
        out["scripts"] = script_plugin_phase(qe, sk, torch, fields)
    finally:
        if engine is not None:
            engine.close()
        shutil.rmtree(froot, ignore_errors=True)
    # every decode step joined its workers when it ended
    left = [t.name for t in set(threading.enumerate()) - threads_before
            if t.is_alive() and t.name.startswith(THREAD_PREFIX)]
    check(not left, f"flows: decode threads outlived their scans: {left}")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"flows, decode, scripts and plugins: phase took "
        f"{out['phase_s']:.1f} s")
    return out


# ---- (g) the observability plane ---------------------------------------------

#: the K1 and K2 kernels' device function names (csrc/), for the
#: profiler's per-kernel device time
K1_KERNELS = ("window_sum_kernel",)
K2_KERNELS = ("fused_agg_kernel", "fused_init_kernel")
#: one span line of an ANALYZE tree: indent, name, ms
TREE_LINE = re.compile(r"^(?P<pad>\s+)(?P<name>[^\s\[][^:]*): "
                       r"(?P<ms>[0-9.]+) ms")


def analyze_report(res) -> dict:
    """An EXPLAIN / TQL ANALYZE result: its trace id, total ms, rows,
    execution path, span tree ((depth, name) rows), resource ledger and
    roofline fold, as printed."""
    lines = [row[0] for row in res.rows()]
    i = next(k for k, ln in enumerate(lines)
             if ln.startswith("ANALYZE trace="))
    head = dict(kv.split("=", 1) for kv in lines[i].split()[1:]
                if "=" in kv)
    out = {"trace_id": head["trace"], "total_ms": float(
        lines[i].split("total=")[1].split()[0]),
        "rows": int(head["rows"]), "path": None, "tree": [], "ledger": {},
        "roofline": None}
    for ln in lines[i + 1:]:
        if ln.startswith("  execution path: "):
            out["path"] = ln.split(": ", 1)[1]
        elif ln.startswith("  resource ledger: "):
            out["ledger"] = {k: float(v) for k, v in (
                kv.split("=") for kv in ln.split(": ", 1)[1].split())}
        elif ln.startswith("  roofline: "):
            out["roofline"] = {k: float(v) for k, v in (
                kv.split("=") for kv in ln.split(": ", 1)[1].split())}
        else:
            m = TREE_LINE.match(ln)
            check(m is not None, f"ANALYZE: unparsed line {ln!r}")
            out["tree"].append((len(m.group("pad")) // 2 - 1,
                                m.group("name"), float(m.group("ms"))))
    return out


def trace_tree(tid) -> list:
    """(depth, name) rows of one trace in this process's span ring."""
    from greptimedb_tpu_torch.utils import tracing

    return [(d, s.name) for d, s, _ in
            tracing.span_tree(tracing.spans_for(tid))]


def kernel_device_ms(fn, torch, names) -> tuple:
    """One run of `fn` under torch.profiler: the device ms of the CUDA
    kernels whose name holds one of `names`, and fn's result."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        res = fn()
        torch.cuda.synchronize()
    ms = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and any(n in e.name for n in names)) / 1e3
    return ms, res


def analyze_checks(name, rep, peak_gbps, *, rows_scanned=None,
                   h2d=None) -> dict:
    """The ledger and roofline checks of one ANALYZE report."""
    led = rep["ledger"]
    if rows_scanned is not None:
        check(led.get("rows_scanned") == rows_scanned,
              f"{name}: ledger rows_scanned {led.get('rows_scanned')}, "
              f"the table holds {rows_scanned}")
    if h2d is not None:
        check(led.get("h2d_bytes", 0) == h2d,
              f"{name}: ledger h2d_bytes {led.get('h2d_bytes')}, the hot "
              f"set uploaded {h2d}")
    rf = rep["roofline"]
    if rf is not None:
        check(abs(rf["peak_gbps"] - peak_gbps) <= 1e-3 * peak_gbps,
              f"{name}: roofline peak {rf['peak_gbps']} is not the card's "
              f"{peak_gbps}")
        check(0 < rf["roofline_fraction"] <= 1.05,
              f"{name}: roofline_fraction {rf['roofline_fraction']}")
    return {"path": rep["path"], "rows": rep["rows"],
            "total_ms": rep["total_ms"], "ledger": led, "roofline": rf,
            "tree": [[d, n, ms] for d, n, ms in rep["tree"]]}


class OtlpCollector:
    """An in-process OTLP/HTTP trace sink: records every posted span."""

    def __init__(self):
        import threading
        from http.server import BaseHTTPRequestHandler, HTTPServer

        self.spans: list = []
        outer = self

        class H(BaseHTTPRequestHandler):
            def do_POST(self):
                n = int(self.headers.get("Content-Length") or 0)
                doc = json.loads(self.rfile.read(n))
                outer.spans.extend(
                    s for r in doc.get("resourceSpans", ())
                    for sc in r["scopeSpans"] for s in sc["spans"])
                self.send_response(200)
                self.send_header("Content-Length", "2")
                self.end_headers()
                self.wfile.write(b"{}")

            def log_message(self, *a):
                pass

        self.httpd = HTTPServer(("127.0.0.1", 0), H)
        self.port = self.httpd.server_address[1]
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       name="chip-smoke-otlp-sink")
        self.thread.start()

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join()


def observability_phase(qe, sk, torch, grid, rows) -> dict:
    """(g) the observability plane on the `cpu` table at full width:
    EXPLAIN ANALYZE of double_groupby_all cold (hot set dropped) and warm
    and of cpu_max_all_8, and one TQL ANALYZE, each with its span tree,
    ledger, roofline against the card's own peak, kernel launches and
    rows; the ledger's device_ms beside the kernel's own device time
    (CUPTI); then a live HttpServer with the flame sampler at its 19 Hz
    default and the OTLP exporter posting to an in-process collector:
    /v1/traces of a traced request, /v1/slow_queries under a lowered
    threshold, /v1/profile/flame and /cluster, /metrics with exemplars,
    and exported spans equal to recorded ones with none dropped."""
    import threading
    import urllib.parse
    import urllib.request

    from greptimedb_tpu_torch.servers import HttpServer
    from greptimedb_tpu_torch.utils import (
        flame,
        otlp_trace,
        roofline,
        slow_query,
        tracing,
    )
    from greptimedb_tpu_torch.utils.otlp_trace import OTLP_TRACE_SPANS

    t_phase = time.perf_counter()
    cuda = torch.cuda.is_available() and DEVICE is None
    out: dict = {}
    peak = roofline.peak_gbps()
    out["peak_gbps"] = peak
    log(f"observability: the card's peak memory rate, read from the card "
        f"(2 x memory clock x bus width): {peak:.3f} GB/s; the data sheet "
        f"figure of the kernel bounds: {HBM_BYTES_PER_S / 1e9:.0f} GB/s")
    if cuda:
        check(abs(peak * 1e9 - HBM_BYTES_PER_S) <= 0.05 * HBM_BYTES_PER_S,
              f"the card's peak {peak} GB/s is not within 5 % of the "
              "H100 data sheet")
    queries = tsbs_queries()
    rid = qe.catalog.table("public", "cpu").region_ids[0]
    cache = qe.executor.cache
    zero_launches(sk)
    with partial_cache(False):
        # double_groupby_all: the plain statement, then EXPLAIN ANALYZE
        # cold (the hot set's blocks of the table dropped) and warm
        sql = queries["double_groupby_all"][0]
        k1, k2 = launches(sk)
        plain = qe.execute_one(sql)
        # the plain statement's launches: one K1 call a device block of
        # the scan (SST parts and the memtable tail)
        plain_k1 = launches(sk)[0] - k1
        check_result("double_groupby_all", plain, grid)
        # its trace: stmt:Select over scan and aggregate > device_agg
        from greptimedb_tpu_torch.session import QueryContext

        ctx = QueryContext(trace_id=tracing.new_trace_id())
        qe.execute_sql(sql, ctx)
        tree = trace_tree(ctx.trace_id)
        check(tree[:1] == [(0, "stmt:Select")] and (1, "scan") in tree
              and (1, "aggregate") in tree
              and tree[tree.index((1, "aggregate")) + 1]
              == (2, "device_agg"),
              f"double_groupby_all: span tree {tree}")
        out["double_groupby_all_trace"] = tree
        for state in ("cold", "warm"):
            if state == "cold":
                # cold: the table's device blocks, and the region's
                # decoded parts and scan snapshots, dropped: the scan
                # decodes every SST again (Region.scan measured alone)
                cache.invalidate_region(rid)
                region = qe.region_engine.region(rid)
                with region._lock:
                    region._scan_cache.clear()
                    region._part_cache.clear()
                    region._part_cache_bytes = 0
            h2d0 = cache.h2d_bytes
            k1, k2 = launches(sk)
            sync(torch)
            res = qe.execute_one("EXPLAIN ANALYZE " + sql)
            sync(torch)
            k1, k2 = launches(sk)[0] - k1, launches(sk)[1] - k2
            rep = analyze_report(res)
            uploaded = cache.h2d_bytes - h2d0
            check(k1 == plain_k1 >= 1 and k2 == 0,
                  f"EXPLAIN ANALYZE double_groupby_all ({state}): {k1} K1 "
                  f"and {k2} K2 launches, the plain statement {plain_k1} K1")
            check(rep["path"] == "dense_prepared" and rep["rows"]
                  == plain.num_rows, f"EXPLAIN ANALYZE double_groupby_all "
                  f"({state}): path {rep['path']}, rows {rep['rows']}")
            names = [(d, n) for d, n, _ in rep["tree"]]
            check((0, "scan") in names and (0, "aggregate") in names
                  and (1, "device_agg") in names,
                  f"EXPLAIN ANALYZE double_groupby_all tree {names}")
            check((uploaded > 0) if state == "cold" else (uploaded == 0),
                  f"double_groupby_all ({state}): the hot set uploaded "
                  f"{uploaded} bytes")
            out[f"double_groupby_all_{state}"] = analyze_checks(
                f"EXPLAIN ANALYZE double_groupby_all ({state})", rep, peak,
                rows_scanned=rows, h2d=uploaded)
            out[f"double_groupby_all_{state}"].update(k1_launches=k1,
                                                      k2_launches=k2)
            log(f"observability: EXPLAIN ANALYZE double_groupby_all "
                f"({state}): " + json.dumps(out[
                    f"double_groupby_all_{state}"]))
        # the ledger's device_ms against K1's own device time
        if cuda:
            kms, res = kernel_device_ms(
                lambda: qe.execute_one("EXPLAIN ANALYZE " + sql), torch,
                K1_KERNELS)
            rep = analyze_report(res)
            dms = rep["ledger"]["device_ms"]
            check(kms > 0 and dms >= kms, f"double_groupby_all: the "
                  f"ledger's device_ms {dms} is under K1's {kms} ms")
            out["device_ms_vs_kernel"] = {"double_groupby_all": {
                "ledger_device_ms": dms, "k1_device_ms": kms}}
        # cpu_max_all_8: K2
        sql8, path8, rows8 = queries["cpu_max_all_8"]
        k2 = launches(sk)[1]
        plain8 = qe.execute_one(sql8)
        plain_k2 = launches(sk)[1] - k2
        check_result("cpu_max_all_8", plain8, grid)
        k1, k2 = launches(sk)
        res = qe.execute_one("EXPLAIN ANALYZE " + sql8)
        k1, k2 = launches(sk)[0] - k1, launches(sk)[1] - k2
        rep = analyze_report(res)
        check(k2 == plain_k2 >= 1 and k1 == 0, f"EXPLAIN ANALYZE "
              f"cpu_max_all_8: {k1} K1 and {k2} K2 launches, the plain "
              f"statement {plain_k2} K2")
        check(rep["path"] == path8 and rep["rows"] == plain8.num_rows == rows8,
              f"EXPLAIN ANALYZE cpu_max_all_8: path {rep['path']}, rows "
              f"{rep['rows']}")
        # the rows its scan holds: the 8 hosts' rows over the first 8 h
        # (a tag predicate keeps the exact in-set rows and range)
        out["cpu_max_all_8"] = analyze_checks(
            "EXPLAIN ANALYZE cpu_max_all_8", rep, peak,
            rows_scanned=8 * (8 * 3600 // STEP_S))
        out["cpu_max_all_8"].update(k1_launches=k1, k2_launches=k2)
        log("observability: EXPLAIN ANALYZE cpu_max_all_8: "
            + json.dumps(out["cpu_max_all_8"]))
        if cuda:
            kms, res = kernel_device_ms(
                lambda: qe.execute_one("EXPLAIN ANALYZE " + sql8), torch,
                K2_KERNELS)
            dms = analyze_report(res)["ledger"]["device_ms"]
            check(kms > 0 and dms >= kms, f"cpu_max_all_8: the ledger's "
                  f"device_ms {dms} is under K2's {kms} ms")
            out["device_ms_vs_kernel"]["cpu_max_all_8"] = {
                "ledger_device_ms": dms, "k2_device_ms": kms}
            log("observability: the ledger's device_ms beside the "
                "kernels' own device time (one warm EXPLAIN ANALYZE each "
                "under torch.profiler): "
                + json.dumps(out["device_ms_vs_kernel"]))
    # one TQL ANALYZE over the PromQL selector of `cpu`: K2 with sumsq
    t0 = T0_MS // 1000
    tql = (f"({t0}, {t0 + HOURS * 3600}, '{CPU_EVAL_STEP_S}s') "
           f"stddev(avg_over_time(cpu{{__field__=\"usage_user\"}}"
           f"[{CPU_RANGE_S // 3600}h]))")
    plain_tql = qe.execute_one("TQL EVAL " + tql)
    k1, k2 = launches(sk)
    res = qe.execute_one("TQL ANALYZE " + tql)
    k1, k2 = launches(sk)[0] - k1, launches(sk)[1] - k2
    rep = analyze_report(res)
    check(k2 >= 1 and k1 == 0, f"TQL ANALYZE: {k1} K1 and {k2} K2 launches")
    check(rep["rows"] == plain_tql.num_rows == CPU_STEPS,
          f"TQL ANALYZE: rows {rep['rows']}, TQL EVAL {plain_tql.num_rows}")
    check([n for _, n, _ in rep["tree"]] == ["promql_scan"],
          f"TQL ANALYZE tree {rep['tree']}")
    out["tql"] = analyze_checks("TQL ANALYZE", rep, peak)
    out["tql"].update(k1_launches=k1, k2_launches=k2)
    log("observability: TQL ANALYZE: " + json.dumps(out["tql"]))

    # a live HttpServer: the flame sampler at its defaults, the OTLP
    # exporter posting to an in-process collector, a lowered slow-query
    # threshold
    before = set(threading.enumerate())
    col = OtlpCollector()
    exp = otlp_trace.configure(f"http://127.0.0.1:{col.port}",
                               flush_interval_s=0.2)
    flame.reset()
    flame.configure(enabled=True)
    slow_query.clear()
    dropped0 = OTLP_TRACE_SPANS.total(event="dropped")
    failed0 = OTLP_TRACE_SPANS.total(event="failed")
    srv = HttpServer(qe, port=0)
    port = srv.start()
    base = f"http://127.0.0.1:{port}"
    traced = []
    slow_env = env_value("GTPU_SLOW_QUERY_MS", "1")
    slow_env.__enter__()
    try:
        with partial_cache(False):
            for sql in (queries["double_groupby_all"][0],
                        queries["cpu_max_all_8"][0],
                        queries["double_groupby_all"][0]):
                tid = tracing.new_trace_id()
                req = urllib.request.Request(
                    base + "/v1/sql",
                    data=urllib.parse.urlencode({"sql": sql}).encode(),
                    headers={"traceparent":
                             f"00-{tid.rjust(32, '0')}-00f067aa0ba902b7-01"})
                with urllib.request.urlopen(req, timeout=300) as r:
                    check(r.status == 200, f"/v1/sql answered {r.status}")
                    echoed = r.headers.get("traceparent") or ""
                    r.read()
                check(tracing.parse_traceparent(echoed)[0] == tid,
                      f"/v1/sql echoed traceparent {echoed!r}")
                traced.append(tid)
        deadline = time.time() + 10
        while time.time() < deadline and not all(
                any(s.name.startswith("http:")
                    for s in tracing.spans_for(t)) for t in traced):
            time.sleep(0.01)
        with urllib.request.urlopen(f"{base}/v1/traces/{traced[0]}",
                                    timeout=60) as r:
            doc = json.loads(r.read())
        names = [s["name"] for s in doc["spans"]]
        check({"http:/v1/sql", "stmt:Select", "scan", "aggregate",
               "device_agg"} <= set(names), f"/v1/traces: spans {names}")
        out["http_trace_tree"] = doc["tree"]
        log("observability: /v1/traces of a traced double_groupby_all "
            "request:\n" + "\n".join(doc["tree"]))
        with urllib.request.urlopen(f"{base}/v1/slow_queries?limit=10",
                                    timeout=60) as r:
            slow = json.loads(r.read())
        recs = [x for x in slow["slow_queries"]
                if x["trace_id"] in traced]
        check(slow["threshold_ms"] == 1.0 and len(recs) == 3,
              f"/v1/slow_queries: {len(recs)} of the 3 statements, "
              f"threshold {slow['threshold_ms']}")
        dga = next(x for x in recs if x["trace_id"] == traced[0])
        check(dga["ledger"].get("rows_scanned") == rows
              and dga["execution_path"] == "dense_prepared"
              and dga["achieved_gbps"],
              f"/v1/slow_queries: the double_groupby_all record {dga}")
        out["slow_query"] = {k: dga[k] for k in (
            "duration_ms", "rows", "execution_path", "ledger",
            "achieved_gbps", "roofline_fraction", "stages")}
        log("observability: /v1/slow_queries, double_groupby_all: "
            + json.dumps(out["slow_query"]))
        with urllib.request.urlopen(f"{base}/v1/profile/flame",
                                    timeout=60) as r:
            folded = r.read().decode()
        with urllib.request.urlopen(f"{base}/v1/profile/cluster",
                                    timeout=60) as r:
            view = json.loads(r.read())
        merged = view["merged"]
        body = [ln for ln in folded.splitlines()[1:] if ln]
        check(body and merged["samples"] > 0,
              "/v1/profile/flame: no samples")
        out["flame"] = {"samples": merged["samples"],
                        "attributed_ratio": merged["attributed"]
                        / merged["samples"],
                        "stages": merged["stages"], "paths": merged["paths"],
                        "top": merged["top"][:5]}
        log("observability: /v1/profile/cluster: " + json.dumps(out["flame"]))
        req = urllib.request.Request(
            f"{base}/metrics",
            headers={"Accept": "application/openmetrics-text"})
        with urllib.request.urlopen(req, timeout=60) as r:
            ctype = r.headers["Content-Type"]
            om = r.read().decode()
        ex = [ln for ln in om.splitlines()
              if not ln.startswith("#") and " # {trace_id=" in ln]
        check("openmetrics-text" in ctype and om.rstrip().endswith("# EOF")
              and ex and all(ln.split("{")[0].endswith("_bucket")
                             for ln in ex)
              and any(t in ln for t in traced for ln in ex),
              "/metrics (OpenMetrics): no trace_id exemplar of the traced "
              "requests on a histogram bucket")
        out["exemplar_lines"] = len(ex)
        check(exp.flush(timeout_s=30.0), "OTLP: the exporter did not drain")
        recorded = {s.span_id for t in traced for s in tracing.spans_for(t)}
        padded = {t.rjust(32, "0") for t in traced}
        exported = {s["spanId"] for s in col.spans
                    if s["traceId"] in padded}
        out["otlp"] = {"recorded": len(recorded), "exported": len(exported),
                       "dropped": OTLP_TRACE_SPANS.total(event="dropped")
                       - dropped0,
                       "failed": OTLP_TRACE_SPANS.total(event="failed")
                       - failed0}
        log("observability: OTLP export: " + json.dumps(out["otlp"]))
        check(recorded and exported == recorded
              and out["otlp"]["dropped"] == 0 and out["otlp"]["failed"] == 0,
              f"OTLP: exported spans differ from recorded {out['otlp']}")
    finally:
        slow_env.__exit__(None, None, None)
        srv.stop()  # joins the server, the flame sampler and the exporter
        qe.concurrency.shutdown()
        col.stop()
        slow_query.clear()
    left = set(threading.enumerate()) - before
    check(not left, f"observability: threads outlived the server: "
          f"{sorted(t.name for t in left)}")
    k1, k2 = launches(sk)
    out["k1_launches"], out["k2_launches"] = k1, k2
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"observability phase (g): {out['phase_s']:.1f} s, launches "
        f"K1 {k1}, K2 {k2}")
    return out


# ---- entry point -------------------------------------------------------------


# ---- phase (m): chaos on the card --------------------------------------------

#: the explorer's budget on the card: tests/test_explorer.py::
#: TestLiveExplorerBudget's own call
CHAOS_EXPLORE = {"runs": 3, "seed": 0, "shrink": False, "num_datanodes": 1,
                 "steps": 24}
#: the hour under chaos: tests/test_chaos.py::TestProcessClusterChaos's
#: seed and schedule (object-store reads fail in every child with
#: probability 0.02, the parent drops a tenth of the heartbeats)
CHAOS_SEED = 1234
CHAOS_READ_PROB = 0.02
CHAOS_BEAT_PROB = 0.1
#: the extra 10 s slice goes in as this many INSERT batches, the largest
#: region's datanode SIGKILLed after CHAOS_KILL_AFTER of them
CHAOS_BATCHES = 12
CHAOS_KILL_AFTER = 6
#: the scenario matrix's cut, to keep the script inside its time limit:
#: these three run (their datanodes do the work on the card); the other
#: two, partition_heal and lease_loss_reelection, are held by their CPU
#: twins (tests/test_torch_scenarios.py) and not run here
CHAOS_MATRIX_KEEP = ("smoke_partition_heal", "partition_crash_failover",
                     "wal_enospc")
#: the hour's reads under chaos run under this deadline: each answers
#: within it or fails typed within it plus the explorer's epsilon (one
#: injected stall, none in this schedule, plus 2 s: explorer._run_live)
CHAOS_READ_DEADLINE_MS = 10000


def card_used_mib(torch) -> int:
    """The card's used memory (nvidia-smi) with this process's cached
    blocks handed back first: what the children hold beside this
    process's context."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return gpu_used_mib()


def chaos_explorer_leg(torch) -> dict:
    """The explorer's tier-1 budget with its children on the card: every
    run must pass; each run's schedule, deadline, ops, acknowledged
    writes, typed failures, WAL objects checked, spawn seconds, its first
    count(*) and its seconds, and the K2 calls its datanodes reported."""
    from greptimedb_tpu_torch.fault import explorer as ex
    from greptimedb_tpu_torch.utils import tracing

    used0 = card_used_mib(torch) if DEVICE is None else 0
    t = time.perf_counter()
    with tracing.collect_spans() as spans:
        rep = ex.explore(**CHAOS_EXPLORE, device=DEVICE)
    out: dict = {"seconds": time.perf_counter() - t, "runs": []}
    for r in rep["runs"]:
        rr = r.get("report") or {}
        line = {"seed": r["seed"], "outcome": r["outcome"],
                "chaos_env": r["chaos_env"], "seconds": r["duration_s"],
                **{k: rr.get(k) for k in (
                    "deadline_ms", "ops", "acked", "typed_failures",
                    "wal_objects_checked", "spawn_s", "first_read_s",
                    "settle_rounds")}}
        for k in ("violation", "error"):
            if k in r:
                line[k] = r[k]
        out["runs"].append(line)
        log("chaos (m) explorer run: " + json.dumps(line))
    check(rep["passed"] == CHAOS_EXPLORE["runs"],
          f"chaos (m) explorer: {rep['failed']} failed, {rep['errors']} "
          "errors")
    out["k2_launches"] = sum(int(sp.attrs.get("k2_launches", 0))
                             for sp in spans if sp.node is not None
                             and sp.name == "region_frag")
    out["k1_launches"] = sum(int(sp.attrs.get("k1_launches", 0))
                             for sp in spans if sp.node is not None
                             and sp.name == "region_frag")
    out["k2_calls"] = [{k: sp.attrs.get(k) for k in (
        "rows", "fields", "segments", "launches", "device_ms")}
        for sp in spans if sp.node is not None and sp.name == "k2"]
    if DEVICE is None:
        out["card_used_mib"] = {"before": used0,
                                "after": card_used_mib(torch)}
        check(out["card_used_mib"]["after"] - used0 < CHILD_CONTEXT_MIB,
              f"chaos (m) explorer: card memory {out['card_used_mib']}")
    log(f"chaos (m) explorer: {out['seconds']:.1f} s; " + json.dumps(
        {k: out.get(k) for k in ("k1_launches", "k2_launches", "k2_calls",
                                 "card_used_mib")}))
    return out


def chaos_election_leg(torch) -> dict:
    """Seed 0's election schedule and skews over three metasrv_main
    processes: one leader re-emerges, epochs are serialized, the
    follower's 409 redirect carries the leader hint, and the children
    leave the card's memory where it was (they open no CUDA context)."""
    import random

    from greptimedb_tpu_torch.fault import explorer as ex

    seen: dict = {}
    used0 = card_used_mib(torch) if DEVICE is None else None

    def on_spawn(_cluster):
        # the children are up: what they hold on the card
        if DEVICE is None:
            seen["used_up"] = card_used_mib(torch)

    entries = [e.to_env() for e in ex.sample_election_schedule(
        random.Random("schedule:0"), ex.Topology.election(3))]
    t = time.perf_counter()
    rep = ex.run_election_schedule(entries, 0, device=DEVICE,
                                   on_spawn=on_spawn)
    out = {"seconds": time.perf_counter() - t,
           "chaos_env": ex.compile_env(entries),
           **{k: rep.get(k) for k in ("leader", "epochs", "lease_epochs",
                                      "redirect_leader_hint", "skews",
                                      "spawn_s", "ready_s", "pids")}}
    check(rep.get("leader") is not None and rep.get("epochs", 0) >= 1
          and rep.get("redirect_leader_hint") == rep["leader"],
          f"chaos (m) election: {rep}")
    check(not any(alive(p) for p in rep["pids"].values()),
          "chaos (m) election: a metasrv child outlived close")
    if DEVICE is None:
        out["card_used_mib"] = {"before": used0, "children_up":
                                seen["used_up"],
                                "after": card_used_mib(torch)}
        check(seen["used_up"] - used0 < CHILD_CONTEXT_MIB,
              f"chaos (m) election: the metasrv children hold card memory "
              f"{out['card_used_mib']}")
    log("chaos (m) election: " + json.dumps(out))
    return out


def chaos_matrix_leg() -> dict:
    """The scenario matrix with its datanodes on the card, cut to the
    three CHAOS_MATRIX_KEEP (the cut is printed)."""
    from greptimedb_tpu_torch.fault.scenarios import SCENARIOS, run_scenario

    out: dict = {"reports": {},
                 "cut": [n for n in SCENARIOS if n not in CHAOS_MATRIX_KEEP]}
    log(f"chaos (m) scenarios: {list(CHAOS_MATRIX_KEEP)} run; cut "
        f"{out['cut']}, held by their CPU twins")
    t_leg = time.perf_counter()
    for name in CHAOS_MATRIX_KEEP:
        t = time.perf_counter()
        rep = run_scenario(name, device=DEVICE)
        rep["seconds"] = time.perf_counter() - t
        out["reports"][name] = rep
        log(f"chaos (m) scenario {name}: " + json.dumps(rep))
    out["seconds"] = time.perf_counter() - t_leg
    return out


def chaos_insert_sql(hosts, ts_ms: int, grid_row: dict) -> str:
    """One INSERT of the `cpu` row of each host in `hosts` at `ts_ms`,
    its fields from `grid_row` (field -> [HOSTS]); repr keeps every
    float64 exactly."""
    cols = ", ".join(["hostname", "ts"] + FIELDS)
    rows = ", ".join(
        f"('host_{h}', {ts_ms}, "
        + ", ".join(repr(float(grid_row[f][h])) for f in FIELDS) + ")"
        for h in hosts)
    return f"INSERT INTO cpu ({cols}) VALUES {rows}"


def chaos_read(c, meter, sk, torch, name, sql, grid, chaos_env) -> dict:
    """One statement through the cluster under chaos, under
    CHAOS_READ_DEADLINE_MS: it answers equal to float64 numpy, with the
    K1 / K2 launches its datanodes report held to the plane fragments (a
    hedge may add one), or fails typed; either within the deadline plus
    the explorer's epsilon (explorer._run_live's rule)."""
    from greptimedb_tpu_torch.fault.explorer import _max_latency_s
    from greptimedb_tpu_torch.fault.scenarios import _typed_failure
    from greptimedb_tpu_torch.session import QueryContext
    from greptimedb_tpu_torch.utils import tracing
    from greptimedb_tpu_torch.utils.metrics import HEDGE_EVENTS

    bound_ms = CHAOS_READ_DEADLINE_MS + (_max_latency_s(chaos_env)
                                         + 2.0) * 1e3
    meter.reset()
    zero_launches(sk)
    fired0 = HEDGE_EVENTS.get(event="fired")
    tid = tracing.new_trace_id()
    sync(torch)
    t = time.perf_counter()
    try:
        res = c.frontend.execute_one(sql, QueryContext(
            trace_id=tid, timeout_ms=CHAOS_READ_DEADLINE_MS))
    except Exception as e:  # noqa: BLE001 — classified below
        ms = (time.perf_counter() - t) * 1e3
        check(_typed_failure(e), f"chaos (m) {name}: UNTYPED "
              f"{type(e).__name__}: {e}")
        check(ms <= bound_ms, f"chaos (m) {name}: failed typed after "
              f"{ms:.1f} ms, past the deadline plus epsilon ({bound_ms} ms)")
        return {"outcome": "failed typed", "error":
                f"{type(e).__name__}: {str(e)[:200]}", "ms": ms,
                "bound_ms": bound_ms}
    sync(torch)
    ms = (time.perf_counter() - t) * 1e3
    check(ms <= bound_ms, f"chaos (m) {name}: answered after {ms:.1f} ms, "
          f"past the deadline plus epsilon ({bound_ms} ms)")
    check_cluster(name, res, grid, lambda x: x)
    fired = int(HEDGE_EVENTS.get(event="fired") - fired0)
    reports = datanode_reports(tid)
    k1 = sum(r["k1_launches"] for r in reports.values())
    k2 = sum(r["k2_launches"] for r in reports.values())
    pk1, pk2 = launches(sk)
    check(k1 == 0 and pk1 == 0 and pk2 == 0,
          f"chaos (m) {name}: K1 {k1} on the datanodes, K1 / K2 {pk1} / "
          f"{pk2} in the frontend")
    # off the card the children run the plain versions: no launch
    check(DEVICE is not None or abs(k2 - meter.planes) <= fired,
          f"chaos (m) {name}: the datanodes report {k2} K2 launches for "
          f"{meter.planes} plane fragments and {fired} hedges")
    return {"outcome": "answered, equal to numpy", "ms": ms,
            "bound_ms": bound_ms,
            "last_path": c.frontend.executor.last_path, "rows": res.num_rows,
            "planes": meter.planes, "hedges_fired": fired,
            "k1_launches": k1, "k2_launches": k2,
            "k2_calls": {n: r["k2_calls"] for n, r in sorted(
                reports.items())}}


def child_injections(paths) -> dict:
    """point -> injections a child logged (GTPU_CHAOS_LOG_THROTTLE_S=0:
    one WARNING line an injection), summed over the children's stderr
    files."""
    out: dict = {}
    for path in paths:
        with open(path, "rb") as f:
            text = f.read().decode(errors="replace")
        for m in re.finditer(r"fault injected point=(\S+) kind=(\S+)", text):
            key = f"{m.group(1)}={m.group(2)}"
            out[key] = out.get(key, 0) + 1
    return out


def chaos_hour_leg(sk, torch, lib, root, host_names) -> dict:
    """tests/test_chaos.py::TestProcessClusterChaos at TSBS size through
    the scenario harness: three datanode processes on the card spawned
    under GTPU_CHAOS (object-store reads fail with probability 0.02 in
    each), a tenth of the parent's heartbeats dropped, phase (l)'s three
    regions, cpu_1h through the scatter write and a flush; cold
    double_groupby_all and cpu_max_all_8 (every region closed and
    reopened, the partial cache off) equal to numpy or failed typed, K2
    from the datanodes' reports; a frontend <-> owner partition (the read
    degrades to Unavailable, five beat rounds start no failover, the
    exact answer after the heal); one more 10 s slice as 12 INSERT
    batches with the owner SIGKILLed after the 6th, failover by
    drive_failover within 30 rounds, and after the heal count(*) and
    double_groupby_all over every acknowledged row. No cut applies."""
    from greptimedb_tpu_torch.fault import FAULTS, Fault
    from greptimedb_tpu_torch.fault.scenarios import (
        BEAT_MS,
        ScenarioRun,
        _typed_failure,
        _warm_up,
        drive_failover,
        read_degrades_typed,
        scenario_cluster,
    )
    from greptimedb_tpu_torch.query.engine import _cached_rule
    from greptimedb_tpu_torch.utils.metrics import FAULT_INJECTIONS

    t_leg = time.perf_counter()
    chaos_env = (f"objectstore.read=fail,prob:{CHAOS_READ_PROB},"
                 f"seed:{CHAOS_SEED}")
    run = ScenarioRun("chip_smoke (m): the hour under chaos", CHAOS_SEED,
                      chaos_env=chaos_env, cmd="python3 chip_smoke.py")
    queries = cluster_queries()
    dga = "double_groupby_all (1 h)"
    out: dict = {"chaos_env": chaos_env,
                 "heartbeat_drop_prob": CHAOS_BEAT_PROB}
    points = ("heartbeat.send", "flight.do_get", "flight.do_put")
    inj0 = {p: FAULT_INJECTIONS.total(point=p) for p in points}
    used0 = card_used_mib(torch) if DEVICE is None else 0
    work = os.path.join(root, "hour")
    pids: dict = {}
    stderr_paths: list = []
    t = time.perf_counter()
    # every injection a line in the children's stderr; cold statements
    # recompute their fragments
    with env_value("GTPU_CHAOS_LOG_THROTTLE_S", "0"), \
            partial_cache(False), \
            scenario_cluster(CHAOS_SEED, work, num_datanodes=3,
                             chaos_env=chaos_env, device=DEVICE) as c:
        pids = {n: dn.pid for n, dn in c.datanodes.items()}
        stderr_paths = [dn.stderr_path for dn in c.datanodes.values()]
        out["spawn"] = {"seconds": time.perf_counter() - t,
                        "ready_s": {n: dn.ready_s
                                    for n, dn in c.datanodes.items()}}
        if DEVICE is None:
            out["spawn"]["gpu"] = children_on_card(pids, used0, "chaos (m)")
        log("chaos (m) hour spawn: " + json.dumps(out["spawn"]))
        FAULTS.arm("heartbeat.send", Fault(kind="fail", prob=CHAOS_BEAT_PROB,
                                           seed=CHAOS_SEED))
        tick = _warm_up(c, 0.0)
        c.sql(cluster_ddl())
        tick = _warm_up(c, tick, rounds=2)  # the regions reported
        info = c.catalog.table("public", "cpu")
        batch, grid = cluster_batch(info, host_names)
        t = time.perf_counter()
        n = c.frontend._sharded_write(info, batch, delete=False)
        put_s = time.perf_counter() - t
        c.sql("ADMIN flush_table('cpu')")
        nodes = [leader_of(c, rid) for rid in info.region_ids]
        check(n == HOSTS * 360 and len(set(nodes)) == 3,
              f"chaos (m) scatter: {n} rows on {nodes}")
        out["put"] = {"rows": n, "seconds": put_s, "rows_per_s": n / put_s,
                      "nodes": nodes}
        # ---- cold reads through the armed objectstore.read ----
        for rid in info.region_ids:
            dn = c.datanodes[leader_of(c, rid)]
            dn.remote.close_region(rid)
            dn.remote.open_region(rid)
        meter = FragmentMeter(c)
        out["reads"] = {}
        for name in (dga, "cpu_max_all_8"):
            out["reads"][name] = chaos_read(c, meter, sk, torch, name,
                                            queries[name][0], grid,
                                            chaos_env)
            log(f"chaos (m) hour {name} (cold): "
                + json.dumps(out["reads"][name]))
        # ---- a frontend <-> owner partition ----
        rid2 = info.region_ids[2]  # the largest region, 1,777 hosts
        owner = leader_of(c, rid2)
        FAULTS.install_partition("frontend", owner)
        t = time.perf_counter()
        run.check(read_degrades_typed(run, c, queries[dga][0]),
                  "double_groupby_all served through a severed "
                  "frontend <-> datanode edge")
        degraded_ms = (time.perf_counter() - t) * 1e3
        dropped = []
        for _ in range(5):
            before = {m: FAULT_INJECTIONS.total(point="heartbeat.send",
                                                node=m) for m in c.datanodes}
            c.beat_all(tick)
            tick += BEAT_MS
            dropped.append(sorted(
                m for m in c.datanodes
                if FAULT_INJECTIONS.total(point="heartbeat.send", node=m)
                > before[m]))
        started = c.tick(tick)
        # a node whose last two beats the heartbeat nemesis dropped may
        # legally be suspected; the data-plane cut alone must not
        run.check(not started or set(dropped[-1]) & set(dropped[-2]),
                  f"the data-plane partition started failover {started} "
                  f"(heartbeats dropped a round: {dropped})")
        FAULTS.heal_partition("frontend", owner)
        healed = chaos_read(c, meter, sk, torch, dga, queries[dga][0], grid,
                            chaos_env)
        check(healed["outcome"].startswith("answered"),
              f"chaos (m) after the heal: {healed}")
        out["partition"] = {"owner": owner, "degraded_ms": degraded_ms,
                            "beats_dropped": dropped,
                            "failovers_started": started,
                            "after_heal": healed}
        log("chaos (m) hour partition: " + json.dumps(out["partition"]))
        # ---- kill -9 mid-write ----
        owner = leader_of(c, rid2)
        rule = _cached_rule(info)
        region_of = rule.find_regions([host_names])
        chunks = [np.array_split(np.flatnonzero(region_of == r),
                                 CHAOS_BATCHES // 3) for r in range(3)]
        # round-robin over the regions: the owner's region has acked,
        # unflushed batches before the kill and failing ones after it
        batches = [(r, chunks[r][k]) for k in range(CHAOS_BATCHES // 3)
                   for r in range(3)]
        ts1 = T0_MS + 3600 * 1000
        row1 = {f: grid[f][0] for f in FIELDS}
        acked_hosts: list = []
        failed: list = []
        victim_pid = c.datanodes[owner].pid
        t = time.perf_counter()
        for i, (r, hosts) in enumerate(batches):
            if i == CHAOS_KILL_AFTER:
                c.kill_datanode(owner)
            try:
                c.sql(chaos_insert_sql(hosts, ts1, row1))
                acked_hosts.extend(int(h) for h in hosts)
            except Exception as e:  # noqa: BLE001 — classified
                run.check(_typed_failure(e),
                          f"INSERT batch {i} failed with UNTYPED "
                          f"{type(e).__name__}: {e}")
                failed.append({"batch": i, "region": r,
                               "error": type(e).__name__})
        write_s = time.perf_counter() - t
        dead_regions = {k for k, rid in enumerate(info.region_ids)
                        if leader_of(c, rid) == owner}
        check(sorted(f["batch"] for f in failed) == [
            i for i, (r, _h) in enumerate(batches)
            if i >= CHAOS_KILL_AFTER and r in dead_regions],
            f"chaos (m) kill: failed batches {failed}")
        t = time.perf_counter()
        tick, rounds = drive_failover(run, c, tick, owner, rid2,
                                      deadline_rounds=30)
        new = leader_of(c, rid2)
        replayed = c.datanodes[new].remote.info(rid2)["replayed_entries"]
        fo_s = time.perf_counter() - t
        check(not alive(victim_pid), "chaos (m): the victim lives")
        # ---- heal, then every acknowledged row ----
        FAULTS.reset()
        for dn in c.datanodes.values():
            if dn.alive:
                dn.remote.chaos_reset()
        count = c.sql("SELECT count(*) FROM cpu").rows()[0][0]
        check(count == HOSTS * 360 + len(acked_hosts),
              f"chaos (m): count(*) {count} for {HOSTS * 360} + "
              f"{len(acked_hosts)} acknowledged rows")
        res = c.sql(queries[dga][0])
        order = np.argsort(np.asarray([f"host_{i}" for i in range(HOSTS)]),
                           kind="stable")
        acked_sorted = sorted(acked_hosts, key=lambda h: f"host_{h}")
        cols = {k: np.asarray(v) for k, v in zip(res.names, res.columns)}
        check(res.num_rows == HOSTS + len(acked_hosts) and np.array_equal(
            cols["hour"].astype(np.int64), T0_MS + np.repeat(
                [0, 3600 * 1000], [HOSTS, len(acked_hosts)])),
            "chaos (m) after the failover: double_groupby_all keys")
        check(np.array_equal(host_index(cols["hostname"]), np.concatenate(
            [order, np.asarray(acked_sorted, dtype=np.int64)])),
            "chaos (m) after the failover: hostnames")
        for f in FIELDS:
            want = np.concatenate([grid[f].mean(axis=0)[order],
                                   row1[f][acked_sorted]])
            check(np.allclose(cols[f"avg({f})"].astype(np.float64), want,
                              rtol=1e-12, atol=0),
                  f"chaos (m) after the failover: avg({f}) over every "
                  "acknowledged row")
        out["kill"] = {"victim": owner, "new_leader": new,
                       "batches": CHAOS_BATCHES, "kill_after": CHAOS_KILL_AFTER,
                       "acked_rows": len(acked_hosts), "failed": failed,
                       "write_s": write_s, "ticks": rounds,
                       "wal_entries_replayed": replayed,
                       "failover_s": fo_s, "count": count}
        log("chaos (m) hour kill -9: " + json.dumps(out["kill"]))
    check(not any(alive(p) for p in pids.values()),
          "chaos (m): a child outlived close")
    out["injections"] = {
        "parent": {p: int(FAULT_INJECTIONS.total(point=p) - inj0[p])
                   for p in points},
        "children": child_injections(stderr_paths)}
    check(out["injections"]["parent"]["heartbeat.send"] > 0,
          "chaos (m): no heartbeat was dropped")
    if DEVICE is None:
        out["card_used_mib"] = {"before": used0,
                                "after": card_used_mib(torch)}
        check(out["card_used_mib"]["after"] - used0 < CHILD_CONTEXT_MIB,
              f"chaos (m): the card's memory did not come back "
              f"{out['card_used_mib']}")
    reads = [*out["reads"].values(), out["partition"]["after_heal"]]
    out["k1_launches"] = sum(r.get("k1_launches", 0) for r in reads)
    out["k2_launches"] = sum(r.get("k2_launches", 0) for r in reads)
    # the datanodes' K2 at the cold double_groupby_all's largest call,
    # against its plain version (synthetic inputs at that shape), after
    # the card's memory was read
    calls = [k for ks in out["reads"][dga].get("k2_calls", {}).values()
             for k in ks]
    if calls:
        big = max(calls, key=lambda k: k["rows"])
        case = {"datanode_device_ms": big["device_ms"],
                "datanode_calls": len(calls),
                "shape": [big["rows"], big["fields"]],
                "G": big["segments"] + 1}
        if lib is not None:
            gen = torch.Generator(device="cuda").manual_seed(SEED)
            vals = torch.rand((big["rows"], big["fields"]),
                              dtype=torch.float64, device="cuda",
                              generator=gen) * 100.0
            ids = torch.randint(0, big["segments"], (big["rows"],),
                                dtype=torch.int32, device="cuda",
                                generator=gen)
            case.update(k2_case(sk, lib, torch, vals, ids,
                                big["segments"] + 1,
                                (False, False, False), "fragment",
                                "chaos (m): the datanode's "
                                "double_groupby_all under chaos"))
        out["k2_shape"] = case
    out["seconds"] = time.perf_counter() - t_leg
    log(f"chaos (m) hour: {out['seconds']:.1f} s; " + json.dumps(
        {k: out.get(k) for k in ("injections", "card_used_mib", "k1_launches",
                                 "k2_launches")}))
    return out


def chaos_phase(sk, torch, lib=None) -> dict:
    """Phase (m), last: the explorer's budget, one election run, the hour
    under chaos at full width and the scenario matrix, every datanode
    child on the card. Prints each leg's seconds."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_chaos_")
    host_names = np.asarray([f"host_{i}" for i in range(HOSTS)],
                            dtype=object)
    out: dict = {}
    if DEVICE is None:
        # this process's own context first: the card-memory checks
        # measure the children beside it
        torch.zeros(1, device="cuda")
    try:
        out["explorer"] = chaos_explorer_leg(torch)
        out["election"] = chaos_election_leg(torch)
        out["hour"] = chaos_hour_leg(sk, torch, lib, root, host_names)
        out["matrix"] = chaos_matrix_leg()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"chaos (m): {out['seconds']:.1f} s (explorer "
        f"{out['explorer']['seconds']:.1f}, election "
        f"{out['election']['seconds']:.1f}, the hour "
        f"{out['hour']['seconds']:.1f}, matrix "
        f"{out['matrix']['seconds']:.1f}; cut {out['matrix']['cut']})")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        from greptimedb_tpu_torch.ops import _build
        from greptimedb_tpu_torch.ops import segment_kernels as sk
    except ImportError as e:
        print(f"chip_smoke: greptimedb_tpu_torch not found beside this "
              f"script ({e})", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    t = time.perf_counter()
    lib = _build.library()
    bind_k1_probes(lib)
    log(f"kernels built in {_build.build_seconds:.2f} s "
        f"(load {time.perf_counter() - t:.2f} s): {_build.LIB_PATH}")
    # the sparse query's per-part partials (about 0.3 GB of keys and
    # planes for 2.9M groups) pass the partial cache's 256 MB default
    os.environ.setdefault("GREPTIMEDB_TPU_PARTIAL_CACHE_BYTES",
                          str(PARTIAL_CACHE_BYTES))
    # the phases before the front door's run as they ran before the port
    # had the plan cache and the fast lane, every statement parsed and
    # planned; the front-door phases build their engines' planes with the
    # JAX defaults (defaults_plane, standalone_options_phase)
    for k, v in LANE_OFF.items():
        os.environ.setdefault(k, v)
    import shutil

    def elapsed(what):
        log(f"[{time.perf_counter() - T_START:.1f} s] {what}")

    main = {}
    # the phase under way, named in the last line of a failure's stderr
    stage = "kernels"
    try:
        kres = kernel_phase(sk, lib, torch)
        elapsed("kernel phase done")
        stage = "main path"
        main = main_path_phase(sk, torch, lib)
        elapsed("main path done")
        stage = "serving"
        serving = serving_phase(sk, torch, lib)
        stage = "high cardinality"
        hc = hc_phase(sk, torch)
        stage = "dedup"
        with partial_cache(False):
            dedup_phase(torch)
        stage = "PromQL"
        prom = promql_phase(sk, torch)
        elapsed("serving, hc, dedup and PromQL done")
        # (j) before the stream: its ingest deadline pays for it
        stage = "(j) object storage"
        store = object_store_phase(sk, torch, card)
        elapsed("object storage, the remote WAL and COPY done")
        # (l) after (d) and (j), before the stream: the in-process
        # cluster over three datanodes
        stage = "(l) the cluster"
        cluster = cluster_phase(sk, torch, lib)
        elapsed("the in-process cluster done")
        stage = "stream"
        stream = stream_phase(sk, torch, lib)
        elapsed("stream done")
        # (k) after the stream: its 10 s of traffic stays out of the
        # stream's ingest deadline
        stage = "(k) the lint plane"
        lint = lint_phase(card)
        elapsed("the lint plane done")
        # after the stream: its ingest deadline is reckoned from the
        # start of the run
        stage = "metric engine"
        metric = metric_phase(sk, torch, prom)
        elapsed("metric engine done")
        stage = "file engine"
        files = file_engine_phase(sk, torch)
        elapsed("file engine done")
        # (h) on a copy of the main path's closed data dir, before (f)
        # touches the original
        stage = "(h) flows"
        flows = flow_phase(main["root"], sk, torch, main["grid"])
        elapsed("flows, parallel decode, scripts and plugins done")
        # (f) last: its ingest and rollup must not push the stream's
        # ingest past its deadline
        stage = "(f) write plane"
        plane = write_plane_phase(main["root"], sk, torch, main["grid"])
        elapsed("write plane done")
        # (m) last of all: chaos on the card (the explorer, an election,
        # the hour under chaos, the scenario matrix)
        stage = "(m) chaos"
        chaos = chaos_phase(sk, torch, lib)
        elapsed("chaos done")
    except CheckFailed as e:
        print(f"chip_smoke: FAILED in {stage}: {e}", file=sys.stderr)
        return 1
    except Exception as e:  # noqa: BLE001 — named, then the exit code
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED in {stage}: {type(e).__name__}: {e}",
              file=sys.stderr, flush=True)
        return 1
    finally:
        if main.get("root"):
            shutil.rmtree(main["root"], ignore_errors=True)
    by_path = {"main (cache off, after ingest)": main["launches"],
               "sparse_fused": {
                   "segment_sum": main["sparse"]["sparse"]["k1_launches"],
                   "fused_segment_agg":
                   main["sparse"]["sparse"]["k2_launches"]},
               "incremental (cache on, after ingest)":
               main["cached"]["ingest"]["launches"],
               "hc dense_prepared": dict(zip(
                   ("segment_sum", "fused_segment_agg"),
                   hc["cache_off"]["cold_launches"])),
               "hc incremental_sparse": dict(zip(
                   ("segment_sum", "fused_segment_agg"),
                   hc["cache_on"]["cold_launches"])),
               "promql prom_cpu (cold runs)": {
                   "segment_sum": 0, "fused_segment_agg": sum(
                       r["k2_launches_cold"] for r in prom.values())},
               "promql cpu (cold runs)": {
                   "segment_sum": 0, "fused_segment_agg": sum(
                       r["k2_launches_cold"]
                       for r in main["promql_cpu"].values())},
               "stream_prepared (cpu_big)": {
                   "segment_sum": stream["cold"]["k1_launches"],
                   "fused_segment_agg": stream["cold"]["k2_launches"]}}
    for state in ("ingest", "compacted"):
        r = main["range"][state]
        by_path[f"range (cpu, after {state})"] = {
            "segment_sum": r["k1_launches"],
            "fused_segment_agg": r["k2_launches"]}
    by_path["range fill (cpu, 8 hosts)"] = {
        "segment_sum": main["range"]["fill"]["k1_launches"],
        "fused_segment_agg": main["range"]["fill"]["k2_launches"]}
    by_path["host sql (cpu, 7 queries, cold runs)"] = main["host_sql"][
        "launches"]
    served = {f"serving {k} (cpu)": v for k, v in main["serving"].items()}
    served["serving qps_mixed_tenants (cpu_1h, vmapped)"] = serving["mixed"]
    served["serving qps_mixed_tenants (cpu_1h, defaults)"] = \
        serving["mixed_defaults"]
    served["serving qps_mixed_tenants (cpu_1h, observability on/off "
           "rounds)"] = serving["plane_ab"]
    served["wire mysql + postgres (cpu)"] = main["wire"]
    served["fabric: frontends A and B (cpu_1h, their own processes)"] = \
        serving["fabric"]
    served["lint plane (k): the lockdep server's mixed traffic (its "
           "/metrics)"] = lint["server"]
    served["flight (d): do_get and do_put on the standalone (its "
           "/metrics)"] = serving["standalone_options"]["flight"]
    for key, r in served.items():
        by_path[key] = {"segment_sum": r["k1_launches"],
                        "fused_segment_agg": r["k2_launches"]}
    for state, res in (("ingest", main), ("reopened", main["reopened"]),
                       ("compacted", main["compacted"])):
        q = res["queries"]["lastpoint"]
        by_path[f"lastpoint lastscan+boundary (after {state})"] = {
            "segment_sum": q["k1_launches"],
            "fused_segment_agg": q["k2_launches"]}
    w = main["writes"]
    by_path["write protocols: cpu_lp (line protocol, cache off)"] = {
        "segment_sum": w["cpu_lp"]["k1_launches"],
        "fused_segment_agg": w["cpu_lp"]["k2_launches"]}
    by_path["write protocols: ingest_qps readers"] = {
        "segment_sum": w["ingest_qps"]["k1_launches"],
        "fused_segment_agg": w["ingest_qps"]["k2_launches"]}
    by_path["write protocols: promql over remote write"] = {
        "segment_sum": 0,
        "fused_segment_agg": w["remote_write"]["k2_launches"]}
    plane_paths = {
        "write plane: ingest_qps readers (standalone defaults)":
        plane["ingest_defaults"],
        "write plane: ingest_qps readers (ingest.group_commit = false)":
        plane["ingest_serial"],
        "rollup (cpu, 1m)": plane["rollup"]}
    for name, q in plane["substitution"].items():
        for route in ("substituted", "raw"):
            plane_paths[f"rollup substitution: {name} ({route}, cold)"] = \
                q[route]
    sq = store["queries"]
    for name in ("double_groupby_all", "cpu_max_all_8"):
        plane_paths[f"object store (j): {name} over s3 (cold)"] = \
            sq[name]["cold"]
        plane_paths[f"object store (j): {name} over s3 (5 warm runs)"] = {
            "k1_launches": sq[name]["warm_k1_launches"],
            "k2_launches": sq[name]["warm_k2_launches"]}
    plane_paths["object store (j): double_groupby_all over s3 (cold, a "
                "cache under the SST's size)"] = \
        sq["double_groupby_all"]["cold_small_cache"]
    plane_paths["object store (j): double_groupby_all over cpu_copy "
                "(COPY FROM parquet)"] = store["copy"]["cpu_copy"]
    plane_paths["object store (j): external parquet table (count(*), "
                "per-host max and avg)"] = store["copy"]["external"]
    plane_paths["cluster (l): 7 statements through Cluster.sql (cold)"] = \
        cluster["launches"]
    plane_paths["cluster (l): double_groupby_all after the failover"] = \
        cluster["failover"]
    plane_paths["cluster (l): process leg, 6 statements (the datanodes' "
                "reports)"] = cluster["process"]
    for name, r in cluster["standalone"].items():
        plane_paths[f"cluster (l): standalone MergeScan {name}"] = r
    plane_paths["chaos (m): the hour under chaos, 3 statements (the "
                "datanodes' reports)"] = chaos["hour"]
    plane_paths["chaos (m): the explorer's 3 runs (the datanodes' "
                "reports)"] = chaos["explorer"]
    plane_paths["observability (g): ANALYZE and HTTP (cpu)"] = main["obs"]
    plane_paths["index: hostname IN (3 hosts) on cpu"] = main["index"]
    plane_paths["metric engine: prom_cpu_m PromQL, SQL panel, neighbour"] = \
        metric
    plane_paths["file engine: cpu_csv and cpu_json (3 queries x 2)"] = files
    plane_paths["flow cpu_hourly: CREATE FLOW (its probe query)"] = \
        flows["create"]
    plane_paths["flow cpu_hourly: first fold (17.28 M rows)"] = \
        flows["first_fold"]
    plane_paths["flow cpu_hourly: tick after one more hour"] = \
        flows["appended_hour"]
    plane_paths["flow cpu_hourly: tick after a restart"] = \
        flows["after_restart"]
    plane_paths["flow cpu_hourly: the direct SQL it is held to"] = \
        flows["direct"]
    plane_paths["flow cpu_p50 (dirty span)"] = flows["dirty_span"]
    for key, name in (("script", "script per_host (/v1/run-script)"),
                      ("plugin", "plugin in double_groupby_all's WHERE"),
                      ("interceptor", "interceptor: 4 fast-lane + 3 "
                       "slow-lane statements")):
        plane_paths[name] = flows["scripts"][key]
    for key, r in plane_paths.items():
        by_path[key] = {"segment_sum": r["k1_launches"],
                        "fused_segment_agg": r["k2_launches"]}
    later_paths = ("promql prom_cpu (cold runs)", "promql cpu (cold runs)",
                   "stream_prepared (cpu_big)", "range (cpu, after ingest)",
                   "range fill (cpu, 8 hosts)",
                   "host sql (cpu, 7 queries, cold runs)",
                   "write protocols: cpu_lp (line protocol, cache off)",
                   "write protocols: ingest_qps readers",
                   "write protocols: promql over remote write") \
        + tuple(served) + tuple(plane_paths)
    sources = {"segment_sum": ("greptimedb_tpu_torch/csrc/segment_sum.cu",
                               "greptimedb_tpu/ops/pallas_segment.py:119"),
               "fused_segment_agg": (
                   "greptimedb_tpu_torch/csrc/fused_segment_agg.cu",
                   "greptimedb_tpu/ops/pallas_segment.py:263")}
    kernels = []
    for name, (src, replaces) in sources.items():
        h = kres[name]["headline"]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": main["launches"][name]
            + sum(by_path[k][name] for k in later_paths),
            "max_abs_err": h["max_abs_err"], "ms": h["ms"],
            "plain_ms": h["plain_ms"], "bound_ms": h["bound_ms"],
            "bound_by": h["bound_by"], "library_ms": h["library_ms"],
            "shape": h["shape"], "G": h["G"],
            "launches_by_path": {k: v[name] for k, v in by_path.items()}})
        if name == "segment_sum":
            kernels[-1]["stream_shape"] = {
                k: kres[name]["stream"][k] for k in (
                    "shape", "G", "dtype", "max_abs_err", "ms", "plain_ms",
                    "bound_ms", "bound_by", "library_ms", "stats")}
        if name == "fused_segment_agg":
            for key, case in (("sparse_shape", "sparse"),
                              ("promql_label_shape", "promql_label"),
                              ("promql_buckets_shape", "promql_buckets"),
                              ("range_shape", "range"),
                              ("lastpoint_ingest_shape", "lastpoint_ingest"),
                              ("lastpoint_flushed_shape",
                               "lastpoint_flushed"),
                              ("rollup_shape", "rollup")):
                sp = kres[name][case]
                kernels[-1][key] = {
                    k: sp[k] for k in ("shape", "G", "dtype", "max_abs_err",
                                       "ms", "plain_ms", "bound_ms",
                                       "bound_by")}
            fc = cluster["fragment_case"]
            kernels[-1]["fragment_shape"] = {
                k: fc.get(k) for k in ("shape", "G", "dtype", "max_abs_err",
                                       "ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms")}
            kernels[-1]["fragment_shape"]["launches"] = \
                cluster["launches"]["k2_launches"]
            for key, case in cluster["process"]["k2_shapes"].items():
                kernels[-1][f"datanode_{key}_shape"] = {
                    k: case.get(k) for k in (
                        "shape", "G", "dtype", "max_abs_err", "ms",
                        "datanode_device_ms", "datanode_calls", "plain_ms",
                        "bound_ms", "bound_by", "library_ms")}
            kernels[-1]["datanode_launches"] = \
                cluster["process"]["k2_launches"]
            hc = chaos["hour"].get("k2_shape", {})
            kernels[-1]["datanode_chaos_shape"] = {
                k: hc.get(k) for k in (
                    "shape", "G", "dtype", "max_abs_err", "ms",
                    "datanode_device_ms", "datanode_calls", "plain_ms",
                    "bound_ms", "bound_by", "library_ms")}
            kernels[-1]["datanode_chaos_shape"]["launches"] = \
                chaos["hour"]["k2_launches"]
            vc = serving["vmapped_case"]
            kernels[-1]["vmapped_shape"] = {
                k: vc[k] for k in ("shape", "G", "dtype", "members",
                                   "max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms",
                                   "launches")}
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
