"""``setup_s``: seconds from the process's start to the end of the warm-up
call: importing torch and the program, the CUDA context, building or
loading the NN kernel's library, reading the data, making the batches and
one call.  Host clock."""


def read(run):
    return run.setup_s
