"""Plain references of the benchmark's configurations: numpy and plain
torch, float32 with TF32 off.  They import nothing of the program."""
