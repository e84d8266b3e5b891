"""The systems under test: each module builds one kind of index of the
program from a configuration and answers host batches through its
public entry points."""
