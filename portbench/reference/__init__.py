"""The benchmark's plain reference: the port's filter code and plain twins,
frozen here with their imports rewritten, so that nothing of the program
under test is imported.  Every kernel is replaced by its plain twin; the
rest is the port's code as it stood when the benchmark was defined."""
