"""Environment names the port reads: its own copy of the names it uses from
the orchestrator's constants. The executor exports ``tony.serving.*`` conf as
``TONY_SERVING_*`` and a chief serving task's reserved port as ``TB_PORT``;
under ``--framework pytorch`` it injects the task identity and the
``torch.distributed`` rendezvous (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``, ``CLUSTER_SPEC``).
"""

JOB_NAME = "JOB_NAME"
TASK_INDEX = "TASK_INDEX"
TASK_NUM = "TASK_NUM"
SESSION_ID = "SESSION_ID"
CLUSTER_SPEC = "CLUSTER_SPEC"
RANK = "RANK"
WORLD_SIZE = "WORLD_SIZE"
MASTER_ADDR = "MASTER_ADDR"
MASTER_PORT = "MASTER_PORT"
TB_PORT = "TB_PORT"
# The profiler port the executor reserves when tony.profiler.enabled is set
# (profiling.maybe_start_profiler_server serves on it).
PROFILER_PORT = "PROFILER_PORT"
TONY_LOG_DIR = "TONY_LOG_DIR"

TONY_SERVING_SLOTS = "TONY_SERVING_SLOTS"
TONY_SERVING_PREFILL_CHUNK = "TONY_SERVING_PREFILL_CHUNK"
TONY_SERVING_DECODE_WINDOW = "TONY_SERVING_DECODE_WINDOW"
TONY_SERVING_MAX_QUEUE = "TONY_SERVING_MAX_QUEUE"
TONY_SERVING_PORT = "TONY_SERVING_PORT"
# The serving engine's KV storage mode (tony.tune.kv-quant): "none" or
# "int8"; parallel/autotune.py reads it.
TONY_TUNE_KV_QUANT = "TONY_TUNE_KV_QUANT"
# The measured autotuner (tony.tune.*): lookups on or off, the default trial
# budget of a search, and where its records live.
TONY_TUNE_ENABLED = "TONY_TUNE_ENABLED"
TONY_TUNE_TRIAL_BUDGET = "TONY_TUNE_TRIAL_BUDGET"
TONY_TUNE_RECORD_DIR = "TONY_TUNE_RECORD_DIR"

# The compile cache (tony.compile.*): the directory the kernel libraries,
# the plan-key index and the plan measurement table live in, and whether it
# is used.
TONY_COMPILE_CACHE_DIR = "TONY_COMPILE_CACHE_DIR"
TONY_COMPILE_CACHE_ENABLED = "TONY_COMPILE_CACHE_ENABLED"

# The jit sanitizer (analysis/jit_sanitizer.py): armed ("1", "report" or
# "strict"), the retraces a wrapper key may take, and where the violation
# report is dumped at exit.
TONY_JIT_SANITIZER = "TONY_JIT_SANITIZER"
TONY_JIT_RETRACE_BUDGET = "TONY_JIT_RETRACE_BUDGET"
TONY_JIT_REPORT_DIR = "TONY_JIT_REPORT_DIR"

# Checkpoint-aware retry: the newest complete step the coordinator saw
# before retrying the session, and the checkpoint dir it probes (exported
# when tony.checkpoint.location is set).
TONY_RESUME_STEP = "TONY_RESUME_STEP"
# The coordinator's planned slice for the job type, as JSON (num_slices,
# hosts_per_slice, ...); runtime.build_job_mesh reads num_slices.
TONY_SLICE_TOPOLOGY = "TONY_SLICE_TOPOLOGY"
TONY_CHECKPOINT_DIR = "TONY_CHECKPOINT_DIR"

# Checkpoint pipeline (tony.ckpt.* conf -> env -> checkpoint/manager.py
# defaults): saves in flight, persist workers, differential saves and their
# full-save interval, background snapshot, and the flush-signal file the
# executor writes when a ckpt_flush order rides its heartbeat reply.
TONY_CKPT_PIPELINE_DEPTH = "TONY_CKPT_PIPELINE_DEPTH"
TONY_CKPT_PERSIST_WORKERS = "TONY_CKPT_PERSIST_WORKERS"
TONY_CKPT_DIFFERENTIAL = "TONY_CKPT_DIFFERENTIAL"
TONY_CKPT_FULL_EVERY = "TONY_CKPT_FULL_EVERY"
TONY_CKPT_BG_SNAPSHOT = "TONY_CKPT_BG_SNAPSHOT"
TONY_CKPT_FLUSH_FILE = "TONY_CKPT_FLUSH_FILE"

# Data-plane tuning (tony.io.* conf -> env -> io/reader.py defaults):
# prefetch depth, read workers, records per chunk.
TONY_IO_PREFETCH_DEPTH = "TONY_IO_PREFETCH_DEPTH"
TONY_IO_READ_WORKERS = "TONY_IO_READ_WORKERS"
TONY_IO_CHUNK_RECORDS = "TONY_IO_CHUNK_RECORDS"

# Telemetry: the file the executor reads the user process's metrics
# snapshot from (piggybacked on its heartbeat), and the tony.stepstats.*
# conf (step anatomy on or off, calibration).
TONY_METRICS_FILE = "TONY_METRICS_FILE"
TONY_STEPSTATS_ENABLED = "TONY_STEPSTATS_ENABLED"
TONY_STEPSTATS_CALIBRATE = "TONY_STEPSTATS_CALIBRATE"
TONY_STEPSTATS_WINDOW = "TONY_STEPSTATS_WINDOW"
# Continuous device-memory telemetry (tony.profile.hbm-interval conf ->
# user-process env -> runtime.initialize starts the HBM gauge monitor,
# observability/profiling.py; "0" disables).
TONY_PROFILE_HBM_INTERVAL_MS = "TONY_PROFILE_HBM_INTERVAL_MS"

# Fault injection (tony.fault.plan): the plan the executor exports to every
# task as JSON, and the task's incarnation (0, or the count of healing
# replacements before it; degrade_task applies to incarnation 0 only).
TONY_FAULT_PLAN = "TONY_FAULT_PLAN"
TONY_TASK_INCARNATION = "TONY_TASK_INCARNATION"
# The offline object store: gs://bucket/key maps onto <dir>/bucket/key
# (cloud.default_storage), inherited by executor subprocesses.
TONY_GCS_EMULATOR_DIR = "TONY_GCS_EMULATOR_DIR"
