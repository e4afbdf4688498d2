"""Process start to the first timed request: imports, building the program
on the card, loading the weights, the inputs, compiling and warming up."""


def read(ctx):
    return ctx["setup_s"]
