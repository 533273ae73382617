"""One file per model family: the port's configuration of a benchmark
configuration file, and the harness's weights in the port's parameter
tree.  These files are the only place that names the port's parameter
keys."""
