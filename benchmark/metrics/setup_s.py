"""Process start to the first timed round, s: the build, the weights and
rows, the roles' set-up and the warm-up rounds."""


def read(run):
    return run.setup_s
