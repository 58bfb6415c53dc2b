"""mapping.capacity: the surfel map's slots (its rung on the capacity
ladder) at the window's end."""


def read(record):
    return record["capacity"]
