"""Pier's algorithm in the port: the schedule, the outer optimizer and the
single-process multi-group simulator."""
