"""The guest's own CPU time in "encoding" + "decoding" a window round, ms:
each record's thread CPU less its children's (decoding's host sync, the
phases' synchronizes in a traced run).  Beside `codec_ms`, the same
phases' wall time, the rest is host syncs and waiting (codec layer)."""

from benchmark.spans import role_ms


def read(run):
    return role_ms(run, "guest", ("encoding", "decoding"), "cpu")
