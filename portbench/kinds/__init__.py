"""The traffic mixes' runners, one module a kind (a traffic file's
``kind``): each makes its inputs, warms up, runs the window and checks
what the timed path produced."""
