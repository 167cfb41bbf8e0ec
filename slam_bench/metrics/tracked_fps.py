"""tracked_fps (frames/s): results that came back TRACKING inside the
window, over the window's seconds (host clock, all the time of the window).
A result counts when the call that returned it ends inside the window,
whichever call handed its frame in: a replay chunk's results come back at
the next boundary, so the window counts the last set-up chunk's and not
its own last chunk's."""


def read(run):
    return run.tracked_in_window / run.window_s
