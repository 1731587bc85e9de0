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
TONY_LOG_DIR = "TONY_LOG_DIR"

TONY_SERVING_SLOTS = "TONY_SERVING_SLOTS"
TONY_SERVING_PREFILL_CHUNK = "TONY_SERVING_PREFILL_CHUNK"
TONY_SERVING_DECODE_WINDOW = "TONY_SERVING_DECODE_WINDOW"
TONY_SERVING_MAX_QUEUE = "TONY_SERVING_MAX_QUEUE"
TONY_SERVING_PORT = "TONY_SERVING_PORT"
