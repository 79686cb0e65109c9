"""index_load_s (program counter): the set-up only the program can
shorten: the tracing spans `index.load` (Index.load) and `index.decode`
(the colour sets' first decode), the latest of each in the process's
totals, seconds. None where the program keeps no such totals."""


def read(run):
    try:
        from fulgor_tpu_torch import tracing
    except ImportError:
        return None
    last = tracing.PROCESS.last
    if "index.load" not in last:
        return None
    return (last["index.load"] + last.get("index.decode", 0)) / 1e9
