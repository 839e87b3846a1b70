"""One driver a kind of job, named by a traffic mix's ``driver``: it sets
the cell up, runs the window, traces and reads the comparison."""
