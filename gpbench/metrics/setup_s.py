"""Set-up seconds: from the process's start to the window's (imports,
kernel libraries built or loaded, data, the model, the warm-up)."""


def read(run):
    return run.setup_s
