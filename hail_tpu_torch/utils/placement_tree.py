"""Header-layout tree used to render nested struct columns as a grid of
spanning header cells (reference `hail/utils/placement_tree.py`)."""

from ..types import tstruct


class PlacementTree:
    """A header cell: field `name` spanning `width` leaf columns, sitting
    `height` levels above the leaves."""

    def __init__(self, name, width, height, children):
        self.name = name
        self.width = width
        self.height = height
        self.children = children

    def __repr__(self):
        return (f'PlacementTree({self.name}, {self.width}, {self.height}, '
                f'{self.children})')

    @staticmethod
    def from_named_type(name, dtype):
        if not isinstance(dtype, tstruct):
            return PlacementTree(name, 1, 0, [])
        kids = [PlacementTree.from_named_type(n, t) for n, t in dtype.items()]
        width = sum(k.width for k in kids)
        height = 1 + max((k.height for k in kids), default=0)
        return PlacementTree(name, width, height, kids)

    def to_grid(self):
        """Rows of (name, width) cells from the top header row down to the
        leaf row; a nested struct appears in the row matching its height and
        spans its leaves, deeper nodes pass through as unnamed spans."""
        grid = []
        level = self.height
        frontier = list(self.children)
        while any(n.height != level for n in frontier):
            row = []
            nxt = []
            for n in frontier:
                if n.height == level:
                    row.append((n.name, n.width))
                    nxt.extend(n.children)
                else:
                    row.append((None, n.width))
                    nxt.append(n)
            grid.append(row)
            frontier = nxt
            level -= 1
        grid.append([(n.name, n.width) for n in frontier])
        return grid
