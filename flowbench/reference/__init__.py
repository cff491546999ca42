"""The benchmark's plain reference (:mod:`.plain_dis`) and the comparison
that decides a run's ``correct`` (:mod:`.check`).  Nothing here imports
the program under test."""
