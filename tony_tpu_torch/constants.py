"""Environment names the port reads: its own copy of the names it uses from
the orchestrator's constants (the executor exports ``tony.serving.*`` conf as
``TONY_SERVING_*``, and a chief serving task's reserved port as ``TB_PORT``).
"""

JOB_NAME = "JOB_NAME"
TASK_INDEX = "TASK_INDEX"
TB_PORT = "TB_PORT"
TONY_LOG_DIR = "TONY_LOG_DIR"

TONY_SERVING_SLOTS = "TONY_SERVING_SLOTS"
TONY_SERVING_PREFILL_CHUNK = "TONY_SERVING_PREFILL_CHUNK"
TONY_SERVING_DECODE_WINDOW = "TONY_SERVING_DECODE_WINDOW"
TONY_SERVING_MAX_QUEUE = "TONY_SERVING_MAX_QUEUE"
TONY_SERVING_PORT = "TONY_SERVING_PORT"
