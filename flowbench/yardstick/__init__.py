"""The benchmark's yardstick, frozen here so that a change to the program
cannot move it: device-event categories, the interval arithmetic of a
trace, and the least time a kernel's work could take."""
