"""Train, eval and serve steps and the fault-tolerant runner of the port."""
