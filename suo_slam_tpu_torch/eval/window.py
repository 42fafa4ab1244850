"""A standard-library Tk window that shows PNG frames, for the port's
interactive views (the JAX package's `cv2.imshow` windows): evaluation's
`--show_viz`, `view_sym_choice --show` and the labeling window of
`manual_keypoints`. Tk decodes the frame's PNG bytes itself
(`data/png.encode` makes them), so nothing here needs OpenCV or Pillow."""

from __future__ import annotations

import base64
import os


class WindowError(RuntimeError):
    """Tk is missing, or cannot open or update the window."""


def display_server() -> str | None:
    """The display server a window would open on (`DISPLAY` or
    `WAYLAND_DISPLAY`), None on a headless machine."""
    return os.environ.get("DISPLAY") or os.environ.get("WAYLAND_DISPLAY") or None


class Window:
    """One Tk window holding one image; `on_click(fn)` calls fn(x, y) for a
    left-button press in image pixels, `on_key(fn)` fn(char) for a key
    press (Enter is "\\r", Esc "\\x1b"). Raises WindowError where Tk cannot
    serve it."""

    def __init__(self, title: str):
        try:
            import tkinter
        except ImportError as e:
            raise WindowError(f"no tkinter: {e}") from e
        self._tk = tkinter
        try:
            self.root = tkinter.Tk()
            self.root.title(title)
            self.label = tkinter.Label(self.root, borderwidth=0, highlightthickness=0)
            self.label.pack()
        except tkinter.TclError as e:
            raise WindowError(str(e)) from e

    def show(self, png_bytes: bytes) -> None:
        """Show the PNG image `png_bytes` and process pending events."""
        try:
            photo = self._tk.PhotoImage(master=self.root, data=base64.b64encode(png_bytes))
            self.label.configure(image=photo)
            self.label.image = photo  # Tk keeps no reference of its own
            self.root.update()
        except self._tk.TclError as e:
            raise WindowError(str(e)) from e

    def on_click(self, fn) -> None:
        self.label.bind("<Button-1>", lambda e: fn(e.x, e.y))

    def on_key(self, fn) -> None:
        self.root.bind("<Key>", lambda e: fn(e.char))

    def run(self) -> None:
        """Process events until `close`."""
        self.root.mainloop()

    def close(self) -> None:
        self.root.destroy()
