"""One module a kind of configuration: the program's run and the
reference's step for it (``Driver``)."""
