"""setup_s (s): from the process's start to the window's opening:
imports, fitting the classifiers, building the program's chips, the
input pool, kernel builds and loads, and warm-up."""


def read(ctx):
    return ctx.get("setup_s")
