"""The timed window over the rounds completed in it, ms: a time a round
over all the window's work, never a median of rounds."""


def read(run):
    return (run.out.t1 - run.out.t0) / run.out.rounds * 1e3
