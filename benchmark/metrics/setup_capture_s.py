"""setup_capture_s: seconds from the first call of the program's step
or serving function to the last capture (train: the first epoch and its
eval, every shape class's graphs; serve: two calls per shape class)."""


def read(ctx):
    return ctx["stages"]["capture"]
