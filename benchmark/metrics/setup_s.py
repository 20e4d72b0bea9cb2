"""setup_s: seconds from the start of the process to the end of the
warm-up (imports, the tables made on the card, the batches, the session,
one run of each query of the mix), on the host's clock."""


def read(obs, name):
    return obs.setup_s
