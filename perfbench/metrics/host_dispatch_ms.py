"""Train step layer (``models/train.py``): the step anatomy's ``host``
phase, mean ms over the window's observed steps. On the card it is the
device clock's gap between one step's end and the next step's start
(the two CUDA events ``StepStats.mark_begin`` and ``mark_end`` record a
step), less the step's ``data_wait`` and ``h2d``: the time the device
waits on the host between steps. Without those events (the CPU) it is
the host time one call of the step takes to dispatch its work. The name
is the one its series has had since it read the dispatch time."""


def read(r):
    if not r.phases:
        return None
    return sum(p["host"] for p in r.phases) / len(r.phases)
