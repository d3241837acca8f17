"""The yardstick's arithmetic: the card's peaks, the SSD scan's operations
and bytes, and the model FLOPs of a configuration.  Frozen copies, so a
later change to the program cannot move them."""
