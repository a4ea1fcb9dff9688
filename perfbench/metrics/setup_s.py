"""setup_s: seconds from the start of the process until the window opens
(imports, weights and inputs made on the card, the program built, every
kernel built or loaded, the warm-up), on the host clock."""


def read(run):
    return run.setup_s
