"""Process start to the first timed call: imports, the library load or
build, the weights from the seed, the program built, the warm-up."""


def read(rec):
    return rec["setup_s"]
