"""One driver per kind of traffic, named by a traffic file's ``driver`` key.

A driver's ``setup()`` builds the program's objects and the seeded inputs
and warms every shape of the window; ``window(seconds)`` runs the
traffic for ``seconds`` and returns what it did (a traced run calls it
twice, and the answers of both windows are judged); ``release()`` frees the
program's state; ``readings(control)`` runs the reference after the
window and returns the numbers that decide ``correct`` (and, with
``control``, the same numbers of the reference in TF32 put in the
program's place).
"""
